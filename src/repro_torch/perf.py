"""The hill-climb over variants: trace a cell VARIANT, compare roofline
terms.

    python -m repro_torch.perf --cell deepseek_v2_lite_16b --variant all
    python -m repro_torch.perf                   # all 14 variants

Counterpart of the reference's ``perf.py``.  Each variant is a cell
(``arch/shape``), a name, a hypothesis and a config transform (the
reference's variants also carry rules for the step builders, and none
of them sets any: the port's steps take the default rules);
``run_variant`` traces the cell's step as
rank 0 of the placeholder 16 x 16 production mesh on meta tensors
(``launch.dryrun.run_cell``: no card, no process group, nothing like
the reference's 512 forced host devices) and writes the port's roofline
row (``roofline.Roofline.row``, terms at the H100's datasheet rates: an
account, not a measurement) with ``cell``, ``variant`` and
``hypothesis`` to ``perf_report.jsonl``; a step that raises gives a
``FAIL`` row.  The output is resumable: a (cell, variant) that already
has an ``ok`` row is skipped.

The hypotheses state what each variant changes in the port's own
terms.  The reference's texts quote its TPU compiles; those figures are
not the port's, and a row's numbers are the port's own account.  Three
of the Qwen3 variants (``attn_pinned``, ``attn_pinned_xsys``,
``qpin_bf16_final``) carry no transform: the reference pinned layouts
that XLA's partitioner chose, and the port's explicit SPMD has those
layouts fixed already, so their rows equal the baseline's (a documented
difference, ROADMAP.md §3).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh


@dataclasses.dataclass
class Variant:
    cell: str                    # "arch/shape"
    name: str
    hypothesis: str
    cfg_transform: Optional[Callable] = None


def _chunk(cfg, n, sub=0):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=n, subchunk=sub))


def _intra_bf16(cfg):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, intra_dtype="bfloat16"))


def _moe_ep(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, parallel_mode="ep"))


def _latent_tp(cfg):
    return dataclasses.replace(cfg, mla_latent_tp=True)


def _latent_tp_bt(n):
    def t(cfg):
        return dataclasses.replace(cfg, mla_latent_tp=True,
                                   kv_block_tokens=n)
    return t


_SAME = ("the port's explicit SPMD has this layout fixed already (decode "
         "attention over the rank's own KV heads, pieces placed by "
         "param_placements): no transform, so the row equals the baseline's")

VARIANTS: List[Variant] = [
    # ---- Cell A: rwkv6_7b x train_4k ----
    Variant("rwkv6_7b/train_4k", "baseline",
            "baseline: chunked RWKV6 time mixing, C=64, direct intra-chunk "
            "decay tensor"),
    Variant("rwkv6_7b/train_4k", "chunk16",
            "H1: the (C, C, dk) intra-chunk decay tensor's elementwise "
            "passes dominate the bytes; C 64->16 shrinks it 4x a chunk at "
            "the cost of 4x more state carries",
            cfg_transform=lambda c: _chunk(c, 16)),
    Variant("rwkv6_7b/train_4k", "chunk8",
            "H2: C 16->8 halves the intra-chunk tensor again; the gain "
            "shrinks as the projections' and ddlerp's bytes take over",
            cfg_transform=lambda c: _chunk(c, 8)),
    Variant("rwkv6_7b/train_4k", "sub16",
            "H3: keep C=64 for the state carries, tile the intra-chunk "
            "body in subchunks of 16: the decay tensor shrinks 4x while "
            "the chunk count stays",
            cfg_transform=lambda c: _chunk(c, 64, 16)),
    Variant("rwkv6_7b/train_4k", "sub16_c256",
            "H4: C=256 with subchunks of 16 cuts the state carries 4x at "
            "an unchanged tile",
            cfg_transform=lambda c: _chunk(c, 256, 16)),
    Variant("rwkv6_7b/train_4k", "intra_bf16",
            "H5: the intra-chunk decay tensor and score operands in "
            "bfloat16 (float32 accumulation) halve the dominant "
            "elementwise bytes",
            cfg_transform=_intra_bf16),
    # ---- Cell B: qwen3_moe_30b_a3b x decode_32k ----
    Variant("qwen3_moe_30b_a3b/decode_32k", "baseline",
            "baseline: tensor-parallel MoE (d_ff split), each rank's pool "
            "holding the KV head its query heads read (4 KV heads over 16 "
            "ranks)"),
    Variant("qwen3_moe_30b_a3b/decode_32k", "attn_pinned",
            "H2: pin decode attention to a batch-only layout; " + _SAME),
    Variant("qwen3_moe_30b_a3b/decode_32k", "attn_pinned_xsys",
            "H3: the pinned attention layout with the pools threaded "
            "layer by layer; the port's pools are updated in place layer "
            "by layer already and " + _SAME),
    Variant("qwen3_moe_30b_a3b/decode_32k", "qpin_bf16_final",
            "H4: pin only q/o, bf16 attention operands with float32 "
            "accumulation; the port's #1 reads the pool's bf16 rows and "
            "accumulates in float32 already and " + _SAME),
    Variant("qwen3_moe_30b_a3b/decode_32k", "moe_ep",
            "H1: decode's collective term is the tensor-parallel MoE's "
            "all-reduce of the whole (B, d) activation each layer; expert "
            "parallelism moves only the routed copies (all_to_all), fewer "
            "bytes at top_k 8 over 16 ranks",
            cfg_transform=_moe_ep),
    # ---- Cell C: deepseek_v2_lite_16b x decode_32k ----
    Variant("deepseek_v2_lite_16b/decode_32k", "baseline",
            "baseline: absorbed MLA over the one-stream latent pool "
            "(kv_lora || rope, 576 lanes), replicated over the model axis "
            "(the latent has no head dim); #7 reads it"),
    Variant("deepseek_v2_lite_16b/decode_32k", "latent_tp",
            "H1: split the pool's kv_lora stream over 'model' on its lanes "
            "(32 of 512 a rank at 16), the rope stream whole: the pool's "
            "bytes a rank fall from 576 to 96 lanes a token; the scores "
            "become partial sums, all-reduced each layer (float32, every "
            "head and position), and the output a row-parallel sum; the "
            "query projections replicate (every head on every rank)",
            cfg_transform=_latent_tp),
    Variant("deepseek_v2_lite_16b/decode_32k", "latent_tp_bt128",
            "H2: with the pool split, 128-token blocks halve the block "
            "tables and the per-block bookkeeping; the split kernels take "
            "any block size",
            cfg_transform=_latent_tp_bt(128)),
]


def run_variant(v: Variant, out_path: str, *,
                mesh: Optional[Mesh] = None) -> Dict:
    """Trace ``v``'s cell and append its row to ``out_path``: the port's
    roofline row of rank 0 of ``mesh`` (the placeholder 16 x 16
    production mesh by default) with ``cell``, ``variant``,
    ``hypothesis``, ``status`` and ``t_total_s``; ``FAIL`` with the error
    where the step raises."""
    if mesh is None:
        mesh = make_production_mesh(placeholder=True)
    arch, shape_name = v.cell.split("/")
    t0 = time.time()
    row = {"cell": v.cell, "variant": v.name, "hypothesis": v.hypothesis}
    row.update(dryrun.run_cell(arch, shape_name, mesh=mesh, verbose=False,
                               cfg_transform=v.cfg_transform))
    if row["status"] == "FAIL":
        row["trace"] = row.get("trace", "")[-1500:]
    row["t_total_s"] = round(time.time() - t0, 1)
    with open(out_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def summary(row: Dict) -> str:
    """The reference's line for a row: terms, bottleneck, fraction and
    the top three ``mem_by_op`` entries; or the failure."""
    if row["status"] != "ok":
        return f"  FAIL {row.get('error')}"
    by = row.get("mem_by_op_gb", {})
    top = ", ".join(f"{k}={v:.2f}GB" for k, v in list(by.items())[:3])
    return (f"  t=({row['t_compute_s']:.3f}, {row['t_memory_s']:.3f}, "
            f"{row['t_collective_s']:.3f})s bn={row['bottleneck']} "
            f"frac={row['roofline_fraction']:.4f}"
            + (f" mem[{top}]" if top else ""))


def done_rows(out_path: str) -> set:
    """The (cell, variant) pairs that already have an ``ok`` row."""
    done = set()
    if os.path.exists(out_path):
        for line in open(out_path):
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") == "ok":
                done.add((r["cell"], r["variant"]))
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="all")
    ap.add_argument("--variant", default="all")
    ap.add_argument("--out", default="perf_report.jsonl")
    args = ap.parse_args(argv)
    done = done_rows(args.out)
    rows = []
    for v in VARIANTS:
        if args.cell != "all" and not v.cell.startswith(args.cell):
            continue
        if args.variant != "all" and v.name != args.variant:
            continue
        if (v.cell, v.name) in done:
            continue
        print(f"[perf] {v.cell} :: {v.name}", flush=True)
        row = run_variant(v, args.out)
        print(summary(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
