"""Paper Table 2: linear and strided scans, tree against contiguous
array, naive against iterator discipline, across array sizes.

The counterpart of the reference's ``benchmarks/bench_tree_scan.py``,
at its sizes (4 KB-256 MB) plus 1 GB and 4 GB, where the card's 50 MB
L2 no longer holds the array and the 4 GB tree needs a fourth level.
Leaves of 8192 float32 (the paper's 32 KB block), fanout 256.  For each
size the tree must hold the dense array bitwise (``to_dense``, through
the ``tree_gather`` kernel) and ``scan_sum_iter`` (through
``tree_block_sum``) must be within ``SUM_TOL`` of the float64 sum.

    python -m repro_torch.bench.tree_scan [--device cpu] [--sizes 4MB,64MB]
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import (chunks, emit, generator, main,
                                      require, time_fn)
from repro_torch.core.treearray import TreeArray
from repro_torch.device import resolve_device

LEAF = 8192          # 32 KB of f32 -- the paper's block
FANOUT = 256         # keeps depth-3 reachable at the reference's sizes

# (label, n elements)  4 KB .. 4 GB
SIZES = [("4KB", 1 << 10), ("4MB", 1 << 20), ("64MB", 1 << 24),
         ("256MB", 1 << 26), ("1GB", 1 << 28), ("4GB", 1 << 30)]
NAIVE_MAX = 1 << 20  # the naive per-element walk only up to 4 MB
STRIDE = 1024        # strided scan: every 1024th element (4 KB apart)
# |scan - float64 sum| <= SUM_TOL * sum|x|: float32 sums of n terms in
# any order are within (chain length) * 2^-24 * sum|x|; the kernel's
# chains (a thread's run of a leaf, a tree over the CTA, the sum over
# leaves) stay far below the 168 additions that 1e-5 allows.
SUM_TOL = 1e-5


def run(device="cuda", sizes=SIZES):
    """Run Table 2 at each ``(label, n)`` of ``sizes``; returns the
    rows (``name``, ``us``, ``derived``)."""
    dev = resolve_device(device)
    g = generator(dev, 0)
    rows = []
    for label, n in sizes:
        x = torch.randn(n, generator=g, device=dev)
        t = TreeArray.from_dense(x, leaf_size=LEAF, fanout=FANOUT,
                                 shuffle_seed=1, device=dev)
        require(torch.equal(t.to_dense(), x),
                f"tree_scan {label}: to_dense() differs from the array")
        want = sum(float(c.double().sum()) for c in chunks(x))
        tol = SUM_TOL * sum(float(c.double().abs().sum()) for c in chunks(x))
        err = abs(float(t.scan_sum_iter()) - want)
        require(err <= tol, f"tree_scan {label}: scan_sum_iter is {err} "
                f"from the float64 sum (tol {tol})")

        us_dense = time_fn(torch.sum, x, device=dev)
        rows.append(emit(f"linear_scan_dense_{label}", us_dense,
                         f"depth=0,n={n}"))
        us_iter = time_fn(t.scan_sum_iter, device=dev)
        rows.append(emit(f"linear_scan_tree_iter_{label}", us_iter,
                         f"depth={t.depth},ratio={us_iter / us_dense:.3f}",
                         err=err, tol=tol))

        if n <= NAIVE_MAX:   # the naive walk reads depth ids per element
            err = abs(float(t.scan_sum_naive()) - want)
            require(err <= tol, f"tree_scan {label}: scan_sum_naive is "
                    f"{err} from the float64 sum (tol {tol})")
            us_naive = time_fn(t.scan_sum_naive, device=dev, iters=3,
                               warmup=1)
            rows.append(emit(f"linear_scan_tree_naive_{label}", us_naive,
                             f"ratio={us_naive / us_dense:.3f}", err=err,
                             tol=tol))

        idx = torch.arange(0, n, STRIDE, device=dev)
        require(torch.equal(t.get_naive(idx), x[::STRIDE]),
                f"tree_scan {label}: strided tree reads differ")
        us_sd = time_fn(lambda: x[::STRIDE].sum(), device=dev)
        rows.append(emit(f"strided_scan_dense_{label}", us_sd, ""))
        us_st = time_fn(lambda: t.get_naive(idx).sum(), device=dev)
        rows.append(emit(f"strided_scan_tree_{label}", us_st,
                         f"ratio={us_st / us_sd:.3f}"))
        del t, x, idx
    return rows


if __name__ == "__main__":
    main(run, __doc__, SIZES)
