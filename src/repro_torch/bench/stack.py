"""Paper Fig. 3: split-stack overhead, on the host.

The counterpart of the reference's ``benchmarks/bench_stack.py`` with
the port's ``BlockStack``: gcc's split stack adds a ~3-instruction
space check per function call; the paper measures ~2% typical, 15% on
a pathological call-bound microbenchmark (recursive fib).  ``push``
performs the same check-and-maybe-link.  (a) The pathological case:
iterative fib carrying its frames on a BlockStack against a plain
Python list; (b) a 'typical' loop where stack ops are a small fraction
of the work.  Both stacks must give the same results.

    python -m repro_torch.bench.stack
"""

from __future__ import annotations

import time

from repro_torch.bench.common import emit, require
from repro_torch.core.stack import BlockStack

FIB_N = 22
LOOP = 20000


def _fib_with_stack(n: int, stack) -> int:
    """Iterative fib with an explicit call stack (pathological: every
    'call' is a push/pop pair)."""
    stack.push((n, 0, 0))
    result = 0
    while len(stack):
        m, phase, acc = stack.pop()
        if m <= 1:
            result = m
            continue
        if phase == 0:
            stack.push((m, 1, 0))
            stack.push((m - 1, 0, 0))
        elif phase == 1:
            stack.push((m, 2, result))
            stack.push((m - 2, 0, 0))
        else:
            result = acc + result
    return result


class ListStack:
    """Contiguous baseline (amortized doubling, like a normal stack)."""

    __slots__ = ("_l",)

    def __init__(self):
        self._l = []

    def push(self, x):
        self._l.append(x)

    def pop(self):
        return self._l.pop()

    def __len__(self):
        return len(self._l)


def _typical(stack, n: int) -> float:
    """Admission bookkeeping where stack ops are ~5% of the work."""
    acc = 0.0
    for i in range(n):
        stack.push(i)
        for _ in range(12):           # 'real work'
            acc += i * 1e-9
        if i % 3 == 0 and len(stack):
            stack.pop()
    return acc


def _time(fn, iters=5):
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e6


def run(fib_n: int = FIB_N, loop: int = LOOP):
    """Fib(``fib_n``) and the typical loop of ``loop`` iterations on each
    stack; returns the rows (``name``, ``us``, ``derived``)."""
    a, b = 0, 1
    for _ in range(fib_n):
        a, b = b, a + b
    require(_fib_with_stack(fib_n, ListStack()) == a
            and _fib_with_stack(fib_n, BlockStack(block_size=4096)) == a,
            f"stack: fib({fib_n}) is not {a} on both stacks")
    require(_typical(ListStack(), loop)
            == _typical(BlockStack(block_size=4096), loop),
            "stack: the typical loop differs between the stacks")
    rows = []
    us_list = _time(lambda: _fib_with_stack(fib_n, ListStack()))
    us_block = _time(lambda: _fib_with_stack(fib_n,
                                             BlockStack(block_size=4096)))
    rows.append(emit("fib_stack_contiguous", us_list, ""))
    rows.append(emit("fib_stack_split", us_block,
                     f"overhead={(us_block / us_list - 1) * 100:.1f}%"))
    us_list = _time(lambda: _typical(ListStack(), loop))
    us_block = _time(lambda: _typical(BlockStack(block_size=4096), loop))
    rows.append(emit("typical_stack_contiguous", us_list, ""))
    rows.append(emit("typical_stack_split", us_block,
                     f"overhead={(us_block / us_list - 1) * 100:.1f}%"))
    return rows


if __name__ == "__main__":
    run()
