"""Paper Fig. 4: GUPS (random update) and a pointer chase, tree against
contiguous array; and a paged row lookup (a paged embedding table).

The counterpart of the reference's ``benchmarks/bench_gups.py``, at its
sizes (4-256 MB) plus 1 GB and 4 GB.  GUPS is a scatter-add of 2^16
seeded updates at seeded indices; the dense array and the tree are both
updated in place, so the ratio compares like with like, and after one
round the tree must equal the dense array within ``GUPS_TOL``.  The
pointer chase walks a seeded permutation of 2^20 elements for 4096
steps, one dependent read per step, on both layouts.

The paged row lookup is the counterpart of the reference cost model's
``tree_gather_rows`` case at a real table's width: gemma-2b's embedding
table (256000 rows x 2048, bfloat16, 1.05 GB) held in 32 KB blocks of 8
rows with a seeded placement, 4096 seeded rows looked up through the
``tree_gather_rows`` kernel against ``torch.nn.functional.embedding`` on
the contiguous table; the two must agree bitwise.

    python -m repro_torch.bench.gups [--device cpu] [--sizes 4MB,64MB]
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.bench.common import (chunks, emit, generator, main,
                                      require, time_fn)
from repro_torch.core.treearray import TreeArray
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

LEAF, FANOUT = 8192, 256
SIZES = [("4MB", 1 << 20), ("64MB", 1 << 24), ("256MB", 1 << 26),
         ("1GB", 1 << 28), ("4GB", 1 << 30)]
N_UPD = 1 << 16
# |tree - dense| <= GUPS_TOL * (1 + |dense|) after one round: atomics add
# an index's duplicate updates in no fixed order, and a handful of
# randn terms reordered in float32 move by far less than 1e-5.
GUPS_TOL = 1e-5
CHASE = (1 << 20, 4096)        # (elements, steps): the reference's 4 MB
ROWS_PER_BLOCK = 8             # 8 rows of 2048 bf16 = a 32 KB block
N_ROWS = 4096


def gups(dev: torch.device, g: torch.Generator, label: str, n: int):
    x = torch.zeros(n, device=dev)
    idx = torch.randint(0, n, (N_UPD,), generator=g, device=dev)
    upd = torch.randn(N_UPD, generator=g, device=dev)
    t = TreeArray.from_dense(x, leaf_size=LEAF, fanout=FANOUT,
                             shuffle_seed=1, device=dev)

    def dense_add():
        x.index_put_((idx,), upd, accumulate=True)

    def tree_add():
        t.add(idx, upd)

    dense_add()
    tree_add()
    err, excess = 0.0, False
    for a, b in zip(chunks(t.to_dense()), chunks(x)):
        d = (a - b).abs()
        err = max(err, float(d.max()))
        excess |= bool((d > GUPS_TOL * (1 + b.abs())).any())
    require(not excess, f"gups {label}: tree differs from dense by {err} "
            f"(tol {GUPS_TOL} * (1 + |dense|))")
    us_dense = time_fn(dense_add, device=dev)
    us_tree = time_fn(tree_add, device=dev)
    return [emit(f"gups_dense_{label}", us_dense, f"n={n}"),
            emit(f"gups_tree_{label}", us_tree,
                 f"depth={t.depth},ratio={us_tree / us_dense:.3f}",
                 err=err, tol=GUPS_TOL)]


def chase(dev: torch.device, g: torch.Generator, n: int, steps: int):
    perm = torch.randperm(n, generator=g, device=dev)
    nxt = perm.to(torch.int32)
    t = TreeArray.from_dense(perm.float(), leaf_size=LEAF, fanout=FANOUT,
                             shuffle_seed=2, device=dev)

    def chase_dense():
        i = torch.zeros(1, dtype=torch.long, device=dev)
        for _ in range(steps):
            i = nxt.index_select(0, i).long()
        return i

    def chase_tree():
        i = torch.zeros(1, dtype=torch.long, device=dev)
        for _ in range(steps):
            i = t.get_naive(i).long()
        return i

    require(torch.equal(chase_dense(), chase_tree()),
            "chase: the tree walk ends elsewhere than the dense walk")
    label = f"{n * 4 >> 20}MB" if n >= 1 << 18 else f"{n * 4 >> 10}KB"
    us_d = time_fn(chase_dense, device=dev, iters=5, warmup=1)
    us_t = time_fn(chase_tree, device=dev, iters=5, warmup=1)
    return [emit(f"chase_dense_{label}", us_d, f"steps={steps}"),
            emit(f"chase_tree_{label}", us_t,
                 f"depth={t.depth},ratio={us_t / us_d:.3f}")]


def embedding_table() -> Tuple[int, int, torch.dtype]:
    """(rows, width, dtype) of gemma-2b's embedding table."""
    from repro_torch.configs.base import get_config

    cfg = get_config("gemma_2b")
    return cfg.vocab_size, cfg.d_model, cfg.torch_dtype


def paged_rows_setup(dev: torch.device, rows: int, width: int,
                     dtype: torch.dtype):
    """A seeded (rows, width) table, the same table in blocks of
    ``ROWS_PER_BLOCK`` rows placed by numpy's ``RandomState(0)``, and
    ``N_ROWS`` seeded row ids.  Returns ``(dense, pool, leaf_table,
    row_ids)``; ``leaf_table[b]`` is the block holding rows ``b * RPB``
    onwards."""
    g = generator(dev, 0)
    dense = torch.randn((rows, width), generator=g, device=dev).to(dtype)
    nlb = math.ceil(rows / ROWS_PER_BLOCK)
    pad = nlb * ROWS_PER_BLOCK - rows
    logical = dense if pad == 0 else torch.cat([dense,
                                                dense.new_zeros(pad, width)])
    table = np.random.RandomState(0).permutation(nlb).astype(np.int32)
    table = torch.from_numpy(table).to(dev)
    pool = torch.empty((nlb, ROWS_PER_BLOCK, width), dtype=dtype, device=dev)
    pool.index_copy_(0, table.long(),
                     logical.view(nlb, ROWS_PER_BLOCK, width))
    ids = torch.randint(0, rows, (N_ROWS,), generator=g, device=dev,
                        dtype=torch.int32)
    return dense, pool, table, ids


def paged_rows(dev: torch.device, rows: int, width: int, dtype: torch.dtype):
    dense, pool, table, ids = paged_rows_setup(dev, rows, width, dtype)
    ids_long = ids.long()
    got = ops.tree_gather_rows(pool, ids, table, ROWS_PER_BLOCK)
    require(torch.equal(got, F.embedding(ids_long, dense)),
            "paged rows: the tree lookup differs from the dense one")
    us_d = time_fn(F.embedding, ids_long, dense, device=dev)
    us_t = time_fn(ops.tree_gather_rows, pool, ids, table, ROWS_PER_BLOCK,
                   device=dev)
    what = f"rows={N_ROWS},table={rows}x{width},{str(dtype)[6:]}"
    return [emit("embedding_dense", us_d, what),
            emit("embedding_tree", us_t,
                 f"{what},rows_per_block={ROWS_PER_BLOCK},"
                 f"ratio={us_t / us_d:.3f}")]


def run(device="cuda", sizes=SIZES, chase_shape=CHASE,
        table: Optional[Tuple[int, int, torch.dtype]] = None):
    """GUPS at each ``(label, n)`` of ``sizes``, the pointer chase at
    ``chase_shape`` (elements, steps), and the paged row lookup on
    ``table`` (rows, width, dtype; default gemma-2b's embedding table).
    Returns the rows (``name``, ``us``, ``derived``)."""
    dev = resolve_device(device)
    g = generator(dev, 0)
    rows = []
    for label, n in sizes:
        rows += gups(dev, g, label, n)
    rows += chase(dev, g, *chase_shape)
    rows += paged_rows(dev, *(table or embedding_table()))
    return rows


if __name__ == "__main__":
    main(run, __doc__, SIZES)
