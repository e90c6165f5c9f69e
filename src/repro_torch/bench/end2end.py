"""Paper Fig. 5: the end-to-end cost of the block discipline on a real
workload -- a serving decode step from a PAGED KV cache against one
from a CONTIGUOUS cache (the virtual-memory-style preallocated
rectangle) -- and how it moves with the block size (the paper's §3 claim
that performance is insensitive to it).

The counterpart of the reference's ``benchmarks/bench_end2end.py``,
under its row names: ``decode_paged_bt{8,16,32,64}`` and
``decode_contiguous``.  Each layout is built as the reference builds it:
a paged one through ``kv_config`` with ``block_tokens`` bt and one
``PagedKVManager.admit`` of ``max_seq`` tokens per row; the contiguous
one as a paged cache with one block of ``max_seq`` per row and identity
tables.  Two rows of configurations:

* ``reduced``: the reference's -- ``gemma_2b``'s ``reduced()`` float32
  model, B 8, ``max_seq`` 256, a context of 128 tokens, weights from
  seed 0;
* ``full``: gemma-2b at its published widths in bfloat16, B 8,
  ``max_seq`` 2048, a context of 1024 tokens (302 MB of KV beside 5 GB
  of weights).

Where the reference times zero pools, every layout here holds the same
seeded logical K/V of the context (drawn on the CPU, so a card and the
CPU see the same numbers), written through its own tables by
``PagedKVCache.write_prefill``; so the result gate is not vacuous: each
layout's logits must equal the contiguous layout's within
``F32_LOGIT_TOL`` of max|logit| in float32 and ``LOGIT_TOL`` in
bfloat16, and a planted fault -- the first paged layout with its table
entries permuted by ``FAULT_SEED``, no data moved -- must fail the
float32 gate (in bfloat16 its gap is reported).

Timing: the step is ``model.decode_step(p, tokens, cache)``, not in
place, so every call reads the same lengths (its append rewrites the
same row).  On the card it is captured once as a CUDA graph and
replayed: ``us`` is the replay's median wall time over 10 calls after 3
warm-ups (``bench.common.time_fn``); its device time and the device time
of #1 (``paged_attention_append``, split and merge kernels) per step
come from ``torch.profiler``, and #1's bound from ``roofline.bound``.
On the CPU the step runs eagerly and there is no device time.

    python -m repro_torch.bench.end2end [--device cpu] [--rows reduced]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bench.common import emit, require, sync, time_fn
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.roofline import bound

#: label -> (reduced config, B, max_seq, context tokens)
ROWS = {"reduced": (True, 8, 256, 128), "full": (False, 8, 2048, 1024)}
BLOCK_TOKENS = (8, 16, 32, 64)
# |layout - contiguous| <= tol * max|contiguous|.  float32: the layouts
# differ only in the order #1 sums a row's keys (its pieces follow the
# block size), far below 1e-5; bfloat16: each layer's output rounds to
# bf16 and a one-ulp difference compounds over the layers, so the bf16
# limit (chip_smoke's LOGIT_TOL) only catches gross failures
F32_LOGIT_TOL = 1e-5
LOGIT_TOL = 0.1
FAULT_SEED = 1
#: seed of the weights a row builds, of its logical K/V and of its tokens
SEED = 0
#: the CUDA kernels of #1 on the profiler's trace
APPEND_KERNELS = ("append_split_kernel", "merge_kernel")


def logical_kv(model, B: int, max_seq: int, ctx: int):
    """K and V of ``ctx`` tokens per row from ``SEED``, zero past them,
    shaped ``(L, B, max_seq, KVH, HD)`` in float32 on the CPU."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(SEED)
    shape = (cfg.num_layers, B, max_seq, cfg.kv_heads, cfg.hd)
    k, v = torch.zeros(shape), torch.zeros(shape)
    k[:, :, :ctx] = torch.randn(shape[:2] + (ctx,) + shape[3:], generator=g)
    v[:, :, :ctx] = torch.randn(shape[:2] + (ctx,) + shape[3:], generator=g)
    return k, v


def layouts(model, B: int, max_seq: int, ctx: int,
            device) -> List[Tuple[str, PagedKVCache]]:
    """``(row name, cache)`` of each layout: the paged ones at
    ``BLOCK_TOKENS``, then the contiguous one, each holding the same
    logical K/V with ``seq_lens`` = ``ctx``."""
    dev = resolve_device(device)
    k, v = logical_kv(model, B, max_seq, ctx)
    lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    out = []
    for bt in BLOCK_TOKENS + (max_seq,):
        if max_seq % bt:
            raise ValueError(f"max_seq {max_seq} is not a multiple of {bt}")
        kvcfg = dataclasses.replace(
            model.kv_config(max_seq=max_seq, batch=B), block_tokens=bt,
            num_blocks=B * max_seq // bt, max_blocks_per_seq=max_seq // bt)
        cache = PagedKVCache.create(kvcfg, B, device=dev)
        if bt == max_seq:
            name = "decode_contiguous"
            tables = np.arange(B, dtype=np.int32)[:, None]
        else:
            name = f"decode_paged_bt{bt}"
            mgr = PagedKVManager(kvcfg)
            for s in range(B):
                mgr.admit(s, max_seq)
            tables = np.stack([mgr.device_table(s) for s in range(B)])
        cache.block_tables.copy_(torch.from_numpy(tables))
        out.append((name, cache.write_prefill(k.to(dev), v.to(dev), lens)))
    return out


def step_tokens(cfg, B: int, device) -> torch.Tensor:
    """The step's ``B`` input tokens, drawn as the reference draws them."""
    rng = np.random.RandomState(SEED)
    return torch.from_numpy(rng.randint(0, cfg.vocab_size, B)).to(device)


def permuted(cache: PagedKVCache) -> PagedKVCache:
    """The planted fault: ``cache``'s table entries permuted by
    ``FAULT_SEED`` (no data moved), on copies of its pools, which the
    step's append would otherwise write through the wrong table."""
    tbl = cache.block_tables
    perm = torch.randperm(
        tbl.numel(), generator=torch.Generator().manual_seed(FAULT_SEED))
    return dataclasses.replace(
        cache, k_pool=cache.k_pool.clone(), v_pool=cache.v_pool.clone(),
        block_tables=tbl.reshape(-1)[perm.to(tbl.device)].reshape(tbl.shape))


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def append_bound(model, cache: PagedKVCache, ctx: int):
    """#1's bound over one decode step (all layers): each call reads q,
    the new K/V rows and the live K/V once, writes the new rows and the
    output once; 2 G (HD + VD) operations per live key and kv head."""
    cfg = model.cfg
    B, MB = cache.block_tables.shape
    KVH, HD = cfg.kv_heads, cfg.hd
    G = cfg.num_heads // KVH
    es = cache.k_pool.element_size()
    keys = B * (ctx + 1) * KVH
    per_call = ((B * KVH * G * HD * 2 + 4 * B * KVH * HD) * es
                + keys * 2 * HD * es + (B * MB + B) * 4)
    flops = 2 * keys * G * 2 * HD
    return bound(cfg.num_layers * per_call, cfg.num_layers * flops,
                 cache.k_pool.dtype)


class ReplayedStep:
    """One decode step captured as a CUDA graph over fixed inputs: each
    ``()`` replays it and adds the launches its capture counted."""

    def __init__(self, model, params, tokens, cache):
        dev = tokens.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):       # PyTorch's capture recipe
            for _ in range(3):
                model.decode_step(params, tokens, cache)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model.decode_step(params, tokens, cache)
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts({k: -n for k, n in self.launches.items()})

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.logits


def device_ms(fn, iters: int = 10) -> Tuple[float, float]:
    """(device ms of everything ``fn`` launches, device ms of #1's
    kernels) per call, from one ``torch.profiler`` trace of ``iters``
    calls after a warm-up cycle of the profiler."""
    prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CUDA],
                   schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                    active=1, repeat=1))
    with torch.profiler.profile(**prof_kw) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    total = attn = 0.0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        total += us
        if any(k in e.key for k in APPEND_KERNELS):
            attn += us
    require(total > 0, "torch.profiler traced no device time")
    return total / 1e3 / iters, attn / 1e3 / iters


def run_row(label: str, model, params, device, *, B: int, max_seq: int,
            ctx: int, timed: bool = True) -> List[Dict]:
    """Every layout of one row: the gate, the planted fault, and (with
    ``timed``) each step's time.  Returns one dict per layout, the
    contiguous one last, then the fault's."""
    dev = resolve_device(device)
    cfg = model.cfg
    tol = F32_LOGIT_TOL if cfg.torch_dtype == torch.float32 else LOGIT_TOL
    tokens = step_tokens(cfg, B, dev)
    caches = layouts(model, B, max_seq, ctx, dev)
    logits = {name: model.decode_step(params, tokens, c)[0]
              for name, c in caches}
    want = logits["decode_contiguous"]
    require(bool(torch.isfinite(want).all())
            and tuple(want.shape) == (B, cfg.vocab_size),
            f"{label}: contiguous logits {tuple(want.shape)} not finite")
    fault = gap(model.decode_step(params, tokens,
                                  permuted(caches[0][1]))[0],
                want)
    if tol == F32_LOGIT_TOL:
        require(fault > tol, f"{label}: the planted fault (permuted table "
                f"of {caches[0][0]}) passes the gate: gap {fault:.3e} <= "
                f"{tol}")
    rows = []
    for name, cache in caches:
        g = gap(logits[name], want)
        require(g <= tol, f"{label}: {name} logits differ from the "
                f"contiguous layout's by {g:.3e} of max|logit| (tol {tol})")
        b_ms, by = append_bound(model, cache, ctx)
        row = {"name": name, "row": label, "B": B, "ctx": ctx,
               "block_tokens": cache.config.block_tokens, "gap": g,
               "tol": tol, "logits": logits[name], "us": None,
               "device_ms": None, "attn_ms": None, "bound_ms": b_ms,
               "bound_by": by}
        if timed:
            if dev.type == "cuda":
                step = ReplayedStep(model, params, tokens, cache)
                rg = gap(step(), logits[name])
                require(rg <= tol, f"{label}: {name}'s replayed step "
                        f"differs from its eager step by {rg:.3e}")
                row["us"] = time_fn(step, device=dev)
                row["device_ms"], row["attn_ms"] = device_ms(step)
                del step
            else:
                row["us"] = time_fn(model.decode_step, params, tokens,
                                    cache, device=dev)
        rows.append(row)
    contig = rows[-1]
    for row in rows if timed else ():
        row["step_x_contiguous"] = row["us"] / contig["us"]
        derived = (f"B={B},ctx={ctx},row={label},gap={row['gap']:.2e},"
                   f"x_contiguous={row['step_x_contiguous']:.3f}")
        if row["attn_ms"] is not None:
            row["attn_x_contiguous"] = row["attn_ms"] / contig["attn_ms"]
            derived += (f",device_ms={row['device_ms']:.4f}"
                        f",append_ms={row['attn_ms']:.4f}"
                        f",append_x_contiguous={row['attn_x_contiguous']:.3f}"
                        f",append_bound_ms={row['bound_ms']:.5f}")
        emit(row["name"], row["us"], derived)
    rows.append({"name": "fault_permuted_table", "row": label,
                 "layout": caches[0][0], "gap": fault, "tol": tol,
                 "trips": fault > tol})
    print(f"# {label}: planted fault ({caches[0][0]}, table permuted by "
          f"seed {FAULT_SEED}): gap {fault:.3e} against tol {tol} -> "
          f"{'trips' if fault > tol else 'passes'} the gate", flush=True)
    sync(dev)
    return rows


def row_model(label: str, device):
    """``(model, params)`` of ``label``'s gemma-2b, weights from
    ``SEED``."""
    reduced = ROWS[label][0]
    cfg = get_config("gemma_2b")
    model = build_model(cfg.reduced() if reduced else cfg)
    return model, model.init(seed=SEED, device=resolve_device(device))


def run(device="cuda", rows: Sequence[str] = tuple(ROWS),
        models: Optional[Dict[str, tuple]] = None) -> List[Dict]:
    """Each of ``rows`` in turn, timed; ``models`` may hand in a row's
    ``(model, params)`` (built by ``row_model`` otherwise)."""
    out = []
    for label in rows:
        _, B, max_seq, ctx = ROWS[label]
        model, params = (models or {}).get(label) or row_model(label, device)
        out += run_row(label, model, params, device, B=B, max_seq=max_seq,
                       ctx=ctx)
    return out


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="labels of the rows to run (default: all)")
    args = ap.parse_args(argv)
    want = args.rows.split(",")
    unknown = [r for r in want if r not in ROWS]
    if unknown:
        ap.error(f"unknown rows {unknown}; choose from {list(ROWS)}")
    return run(device=args.device, rows=want)


if __name__ == "__main__":
    main()
