"""The raw cross-check beside the account: ``FlopCounterMode``'s totals.

Counterpart of ``repro.cost.xla``, which normalises XLA's own
``cost_analysis()`` into the row's ``xla_raw``.  PyTorch's own counter
is ``torch.utils.flop_counter.FlopCounterMode``: FLOPs of the matrix
products, attention and convolutions it has formulas for, and no bytes.
Its total goes into the roofline row as ``raw``.  It cannot see a port
kernel (a ctypes launch), so on the card and on meta it counts none of
their FLOPs, while the account does.
"""

from __future__ import annotations

from typing import Dict

from torch.utils.flop_counter import FlopCounterMode


def flop_counter() -> FlopCounterMode:
    """A ``FlopCounterMode`` that prints nothing on exit."""
    return FlopCounterMode(display=False)


def raw(counter: FlopCounterMode) -> Dict[str, float]:
    """The row's ``raw`` entry: ``{"flops": total}``."""
    return {"flops": float(counter.get_total_flops())}
