"""Op-level accounting of the port's own program: the measurement
instrument behind the roofline rows.

Counterpart of ``repro.cost``.  Where the reference walks the optimised
HLO of a compiled program, this package records a step as it runs (on
the card, on the CPU or on meta tensors) and bills every op, every port
kernel launch and every collective for the bytes it moves and the FLOPs
it does (``accounting`` has the rule table), and tracks the peak of live
bytes (``memory``).

  * ``record(track_memory=False)``  -- a context that records: ``with
    record() as rec: step(...)``; ``rec.cost``, ``rec.memory.peak``
  * ``analyze(fn, *args, **kw) -> (Cost, peak)`` -- one call recorded,
    its inputs counted live from the start
  * ``attribute(rec, top=20)``       -- per-(op, shape) byte tally
  * ``Cost``, ``CostMode``, ``COLLECTIVE_OPS``, ``dominant_category``
  * ``kernels``                      -- one bill per kernel launch
  * ``counter``                      -- the raw ``FlopCounterMode`` check

The reference's ``parser.py`` and ``hlo_cost.py`` have no counterpart:
there is no HLO to parse, and ``hlo_cost`` re-exports names for imports
that this package never had.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

from torch.utils._pytree import tree_leaves

from repro_torch.cost import counter, kernels  # noqa: F401
from repro_torch.cost.accounting import (COLLECTIVE_OPS, Cost,  # noqa: F401
                                         CostMode, dominant_category)

__all__ = ["COLLECTIVE_OPS", "Cost", "CostMode", "analyze", "attribute",
           "counter", "dominant_category", "kernels", "record"]


@contextlib.contextmanager
def record(*, track_memory: bool = False):
    """Record every op, kernel launch and collective of the block (the
    mode is exited in a ``finally``)."""
    mode = CostMode(track_memory=track_memory)
    with mode:
        yield mode


def analyze(fn, *args, **kw) -> Tuple[Cost, float]:
    """``fn(*args, **kw)`` recorded: its ``Cost`` and its peak of live
    bytes, the tensors among its arguments counted live from the start."""
    with record(track_memory=True) as rec:
        rec.memory.see(t for t in tree_leaves((args, kw))
                       if hasattr(t, "untyped_storage"))
        rec.memory.start()
        fn(*args, **kw)
    return rec.cost, float(rec.memory.peak)


def attribute(rec: CostMode, top: int = 20):
    """The ``top`` (op, result shape) byte tallies of a recording."""
    return rec.attribute(top)

