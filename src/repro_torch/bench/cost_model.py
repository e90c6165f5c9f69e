"""Cost-model validation: the account's bytes against analytic bytes on
the paper's two indirection primitives, paged-KV access and the tree
gather.

    python -m repro_torch.bench.cost_model                 # the card
    python -m repro_torch.bench.cost_model --device cpu --out cm.json

The counterpart of ``benchmarks/bench_cost_model.py``.  Each case runs
the port's own path once under the cost recorder (``repro_torch.cost``)
and compares its bill with the bytes the operation must move, at the
reference's shapes (B 8, 4 KV heads of 128, 16-token blocks, 512 keys a
row, the pool 4x the live working set; 64 leaves of 8192 float32 from a
512-leaf pool):

* ``paged_kv_read``: the block-table read, ``pool[tables]`` summed over
  the keys (the reference's composition, plain ops);
* ``paged_kv_token_write``: the new token written in place through the
  table, ``index_put_`` (plain ops: the write whose full-pool billing
  the account exists to avoid);
* ``tree_gather``: #8, ``ops.tree_gather``;
* ``paged_kv_append``, on the card only: one decode step's attention
  through the table with the token appended, #1
  (``ops.paged_attention_append``), its rows ``APPEND_LENS`` cached keys
  long.  Its plain version on the CPU materialises float32 copies of the
  gathered rows and moves ~5x the analytic bytes, so it is not a case
  there;
* ``paged_latent``, on the card only, for the same reason: one layer's
  split-latent decode attention through the table, both passes
  (``ops.paged_latent_scores``, ``ops.paged_latent_values``) over a
  lora stream of ``LORA`` lanes and a rope stream of ``ROPE`` for
  ``LAT_HEADS`` heads (DeepSeek-V2-Lite's widths), rows of
  ``APPEND_LENS`` cached keys.

On the CPU the plain versions' ops are billed as they run; on the card
each kernel bills its launch (``cost/kernels.py``), and every case's
device time (``torch.profiler``, ``--iters`` calls) goes beside its
bill's bound (``roofline.bound``).  ``FlopCounterMode``'s FLOPs go
beside as ``raw`` (it cannot see a kernel launch).  A case fails when the
predicted:analytic ratio leaves [0.5, 4.0], as the reference's does.
Rows are printed; JSON is written only to the path ``--out`` names.

The kernels' analytic bytes are what this run's data makes the kernel
touch (``append_touched_bytes``, ``gather_touched_bytes``), read from
the tensors and never from ``cost/kernels.py``: #1's valid keys from its
lengths and the table entries they reach, #8's distinct leaves.  The
account bills #1 at its table's capacity, so its ratio is capacity over
valid keys, ~1.33 at ``APPEND_LENS``; a bill of the whole pool, the
generic rule's overcount, reads ~5.3 there and #8's ~4.5, and fails.
The split-latent pair's are likewise read from its tensors
(``latent_touched_bytes``).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

from repro_torch import cost
from repro_torch.bench.common import emit, generator
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.roofline import bound

RATIO_LO, RATIO_HI = 0.5, 4.0
#: paged-KV case (the reference's paged_kv_read / token write shapes)
B, H, D, BT, S = 8, 4, 128, 16, 512
MB = S // BT
POOL_FACTOR = 4
#: #1's cached keys a row before the append: 255 to 511, a quarter of
#: the table's capacity unused on average
APPEND_LENS = tuple(S // 2 - 1 + b * (S // 2) // (B - 1) for b in range(B))
#: split-latent case: DeepSeek-V2-Lite's heads and latent widths
LAT_HEADS, LORA, ROPE = 16, 512, 64
#: tree-gather case
NB, LEAF, NL = 512, 8192, 64


def append_touched_bytes(q, k_new, v_new, lens, bt: int) -> int:
    """Bytes #1 must move: q read and its output written, the new K/V
    read and written into the pool, each row's ``lens + 1`` keys of K
    and V read, the table entries those keys reach and the lengths."""
    keys = lens.long() + 1
    per_key = k_new[0].numel() * k_new.element_size() \
        + v_new[0].numel() * v_new.element_size()
    blocks = int(((keys + bt - 1) // bt).sum())
    return int(2 * q.nbytes + 2 * (k_new.nbytes + v_new.nbytes)
               + int(keys.sum()) * per_key + blocks * 4 + lens.nbytes)


def latent_touched_bytes(q_lat, q_r, c_pool, lens, bt: int) -> int:
    """Bytes the two split-latent passes must move: the float32 queries
    and self rows read; each row's ``lens`` cached keys of the lora and
    rope streams read in pass 1 and of the lora stream in pass 2, with
    the table entries they reach and the lengths (both passes); the
    (B, H, MB * BT + 1) float32 scores written whole, and read back at
    the valid keys and the self column; the float32 output written."""
    B, H, L = q_lat.shape
    R = q_r.shape[-1]
    es = c_pool.element_size()
    keys = int(lens.long().sum())
    blocks = int(((lens.long() + bt - 1) // bt).sum())
    N = MB * bt
    p1 = (B * H * (L + R) + B * (L + R)) * 4 + keys * (L + R) * es \
        + blocks * 4 + lens.nbytes + B * H * (N + 1) * 4
    p2 = (keys + B) * H * 4 + keys * L * es + B * L * 4 + blocks * 4 \
        + lens.nbytes + B * H * L * 4
    return int(p1 + p2)


def gather_touched_bytes(leaves, table) -> int:
    """Bytes #8 must move: each distinct leaf the table names read, the
    gathered leaves written, the int32 table read."""
    row = leaves[0].nbytes
    return int(table.unique().numel() * row + table.numel() * row
               + table.numel() * 4)


def _device_ms(fn, iters: int, tries: int = 3) -> float:
    """Device time of one ``fn()`` call: every GPU activity of ``iters``
    calls in a ``torch.profiler`` trace, over ``iters``.  A trace that
    kept no device event (the profiler drops a trace's events now and
    then on an H100) is taken again, up to ``tries`` traces."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            us += float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"torch.profiler traced no device time in {tries} "
                       f"traces")


def _case(name: str, fn, analytic: float, dtype: torch.dtype,
          device: torch.device, iters: int) -> Dict:
    with cost.counter.flop_counter() as fc, cost.record() as rec:
        fn()
    c = rec.cost
    ratio = c.bytes / max(analytic, 1.0)
    b_ms, by = bound(c.bytes, c.flops, dtype)
    ms = _device_ms(fn, iters) if device.type == "cuda" else None
    row = {
        "name": name, "device": device.type,
        "predicted_bytes": c.bytes, "analytic_bytes": float(analytic),
        "ratio_predicted_to_analytic": ratio,
        "flops": c.flops, "raw": cost.counter.raw(fc),
        "by_op": {k: v for k, v in sorted(c.by_op.items(),
                                          key=lambda kv: -kv[1])},
        "kernels": {k: v["launches"] for k, v in c.kernels.items()},
        "bound_ms": b_ms, "bound_by": by, "ms": ms,
        "ok": RATIO_LO <= ratio <= RATIO_HI,
    }
    emit(f"cost_model_{name}", 0.0 if ms is None else ms * 1e3,
         f"pred={c.bytes:.0f},analytic={analytic:.0f},ratio={ratio:.3f},"
         f"bound_ms={b_ms:.5f},ok={row['ok']}")
    return row


def paged_kv_case(device: torch.device, iters: int = 30, seed: int = 0
                  ) -> Dict:
    """#1 over the tables of a pool ``POOL_FACTOR`` times the working
    set: rows of ``APPEND_LENS`` cached keys, the new token appended."""
    g = generator(device, seed)
    nblk = POOL_FACTOR * B * MB
    q = torch.randn((B, H, 1, D), generator=g, device=device)
    kn = torch.randn((B, H, D), generator=g, device=device)
    vn = torch.randn((B, H, D), generator=g, device=device)
    kp = torch.randn((nblk, BT, H, D), generator=g, device=device)
    vp = torch.randn((nblk, BT, H, D), generator=g, device=device)
    tables = torch.randperm(nblk, generator=g, device=device)[: B * MB]
    tables = tables.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(APPEND_LENS, dtype=torch.int32, device=device)
    return _case("paged_kv_append", lambda: ops.paged_attention_append(
        q, kn, vn, kp, vp, tables, lens),
        append_touched_bytes(q, kn, vn, lens, BT), kp.dtype, device, iters)


def paged_latent_case(device: torch.device, iters: int = 30, seed: int = 0
                      ) -> Dict:
    """Both split-latent passes over lora and rope pools
    ``POOL_FACTOR`` times the working set: rows of ``APPEND_LENS`` cached
    keys."""
    g = generator(device, seed)
    nblk = POOL_FACTOR * B * MB
    q_lat = torch.randn((B, LAT_HEADS, LORA), generator=g, device=device)
    q_r = torch.randn((B, LAT_HEADS, ROPE), generator=g, device=device)
    c_pool = torch.randn((nblk, BT, LORA), generator=g, device=device)
    r_pool = torch.randn((nblk, BT, ROPE), generator=g, device=device)
    c_new = torch.randn((B, LORA), generator=g, device=device)
    r_new = torch.randn((B, ROPE), generator=g, device=device)
    tables = torch.randperm(nblk, generator=g, device=device)[: B * MB]
    tables = tables.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(APPEND_LENS, dtype=torch.int32, device=device)

    def both():
        s = ops.paged_latent_scores(q_lat, q_r, c_pool, r_pool, tables,
                                    lens, c_new, r_new)
        return ops.paged_latent_values(s, c_pool, tables, lens, c_new)

    return _case("paged_latent", both,
                 latent_touched_bytes(q_lat, q_r, c_pool, lens, BT),
                 c_pool.dtype, device, iters)


def _pool(device: torch.device, seed: int):
    g = generator(device, seed)
    nblk = POOL_FACTOR * B * MB
    pool = torch.randn((nblk, BT, H, D), generator=g, device=device)
    tables = torch.randperm(nblk, generator=g, device=device)[: B * MB]
    return g, pool, tables.reshape(B, MB).to(torch.int32)


def paged_read_case(device: torch.device, iters: int = 30, seed: int = 0
                    ) -> Dict:
    """Every row's blocks gathered through its table and summed over
    the keys."""
    _, pool, tables = _pool(device, seed)
    idx = tables.long()
    gathered = B * MB * BT * H * D * pool.element_size()
    # gather read + materialised write + the sum's re-read + the output
    return _case("paged_kv_read", lambda: pool[idx].sum(dim=(1, 2)),
                 3 * gathered + B * H * D * pool.element_size(), pool.dtype,
                 device, iters)


def token_write_case(device: torch.device, iters: int = 30, seed: int = 0
                     ) -> Dict:
    """Each row's new token written at its length through its table."""
    g, pool, tables = _pool(device, seed)
    kv = torch.randn((B, H, D), generator=g, device=device)
    pos = torch.full((B,), S - 1, dtype=torch.long, device=device)
    blk = tables.long().gather(1, (pos // BT)[:, None])[:, 0]
    flat = pool.view(-1, H, D)
    slot = blk * BT + pos % BT
    token = B * H * D * pool.element_size()
    # the token read and written into its slot, never the pool
    return _case("paged_kv_token_write",
                 lambda: flat.index_put_((slot,), kv), 2 * token,
                 pool.dtype, device, iters)


def tree_gather_case(device: torch.device, iters: int = 30, seed: int = 0
                     ) -> Dict:
    """#8: ``NL`` leaves of a ``NB``-leaf pool in a shuffled order."""
    g = generator(device, seed)
    leaves = torch.randn((NB, LEAF), generator=g, device=device)
    table = torch.randperm(NB, generator=g, device=device)[:NL]
    return _case("tree_gather", lambda: ops.tree_gather(leaves, table),
                 gather_touched_bytes(leaves, table), leaves.dtype, device,
                 iters)


def run(device="cuda", iters: int = 30, out: Optional[str] = None
        ) -> List[Dict]:
    """The cases on ``device``; raises when a ratio leaves its range."""
    dev = resolve_device(device)
    rows = [paged_read_case(dev, iters), token_write_case(dev, iters),
            tree_gather_case(dev, iters)]
    if dev.type == "cuda":
        rows.append(paged_kv_case(dev, iters))
        rows.append(paged_latent_case(dev, iters))
    if out:
        with open(out, "w") as f:
            json.dump({"bench": "cost_model", "cases": rows,
                       "all_ok": all(r["ok"] for r in rows)}, f, indent=2)
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"cost model drifted on: {bad}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="write the cases as JSON to this path")
    args = ap.parse_args(argv)
    run(args.device, args.iters, args.out)


if __name__ == "__main__":
    main()
