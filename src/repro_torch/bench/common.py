"""Timing, seeding and CSV emission for the port's experiments."""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


class ResultMismatch(RuntimeError):
    """A tree result differs from the dense one it must equal."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ResultMismatch(msg)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, device: torch.device, iters: int = 10,
            warmup: int = 3) -> float:
    """Median wall time in microseconds of ``fn(*args)``.  On the card
    each timed call starts and ends with ``torch.cuda.synchronize``, so
    the time covers the device work and the host's launches."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on ``device``: data is made where it lives
    (numpy's ``randn(2**30)`` would take tens of seconds on the host)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def chunks(x: torch.Tensor, size: int = 1 << 26):
    """``x`` flat in pieces of ``size`` elements, so float64 sums and
    element-wise comparisons of a 4 GB array make 512 MB temporaries,
    not 8 GB ones."""
    return x.reshape(-1).split(size)


def emit(name: str, us: float, derived: str = "", **values) -> Dict:
    """Print one ``name,us,derived`` row as the reference's ``emit``
    does, and return it as a dict (``values`` ride along unprinted)."""
    print(f"{name},{us:.2f},{derived}", flush=True)
    return {"name": name, "us": us, "derived": derived, **values}


def main(run: Callable[..., List[Dict]], doc: Optional[str],
         sizes: List[Tuple[str, int]], argv=None) -> List[Dict]:
    """The command line of a bench: ``--device`` (cuda by default; cpu
    runs the kernels' plain versions) and ``--sizes``, a comma-separated
    subset of the bench's size labels (all by default)."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(l for l, _ in sizes),
                    help="labels of the sizes to run (default: all)")
    args = ap.parse_args(argv)
    by_label = dict(sizes)
    want = args.sizes.split(",")
    unknown = [l for l in want if l not in by_label]
    if unknown:
        ap.error(f"unknown sizes {unknown}; choose from {list(by_label)}")
    return run(device=args.device, sizes=[(l, by_label[l]) for l in want])
