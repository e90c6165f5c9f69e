"""Peak live bytes of a step, from the storages the dispatcher sees.

The counterpart of the reference's ``memory_analysis()`` sum (arguments
+ temporaries + outputs - aliases, ``src/repro/roofline.py``): each
storage is counted once, from the first op that takes or returns a
tensor on it (or from ``see`` on the step's inputs) until a weakref
finalizer on its ``untyped_storage()`` fires, which happens when the last
tensor on it goes, views included.  This holds on meta tensors too, so a
dry run has a peak without a card.  Storages are keyed by their C
object, which stays unique while they live.
"""

from __future__ import annotations

import threading
import weakref
from typing import Iterable

import torch


class LiveBytes:
    """Live and peak bytes over the storages seen so far."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen = {}
        self._lock = threading.Lock()

    def see(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue            # a tensor without storage of its own
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            with self._lock:
                self._seen[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._gone, key)

    def _gone(self, key) -> None:
        with self._lock:
            self.live -= self._seen.pop(key, 0)

    def start(self) -> int:
        """Reset the peak to the bytes live now; returns them."""
        with self._lock:
            self.peak = self.live
            return self.live
