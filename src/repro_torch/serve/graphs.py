"""Captured CUDA graphs of one kind, keyed by bucket, in one memory pool
that a strategy's kinds share.

What the resident decode tail (``serve/decode_graph.py``) and the
prefill buckets (``serve/prefill_graph.py``) have in common:

* ``addresses`` and ``upload``: what a graph replays, and the host's
  arrays into their static device buffers without waiting;
* ``GraphPool``: one private memory pool (``torch.cuda.graph_pool_handle``)
  and one side stream, shared by every ``GraphSet`` of one strategy.
  Sharing is safe because a strategy's graphs never replay concurrently
  (each replays on the current stream, one call after another), each
  graph's outputs stay alive for as long as the graph does (no live
  output returns to the pool), and a caller clones what it keeps before
  another replay can run.  The pool's handle is dropped once no graph of
  any set lives in it, so a later capture opens a fresh one;
* ``GraphSet``: the graphs of one kind, keyed by bucket.  ``check``
  compares the tensors a graph replays besides its own buffers -- the
  parameters, the pools, the resident tables -- by address and shape with
  those at capture; where one moved (the transfer plane may rebind a pool
  through its executor), every graph of the set is dropped and
  ``recaptures`` counts it.  ``capture`` follows PyTorch's recipe: the
  caller's warm-up runs ``warmup`` times (``WARMUP`` unless the kind
  says otherwise) on the side stream (building the kernel
  libraries and setting up cuBLAS on that stream) over inputs whose
  every write lands in a sink block or a scratch row, then the body is
  recorded on the same stream with Python's cycle collector off: a
  collection inside the capture could free a pinned host buffer that a
  copy on the default stream used (a swap-in's payload, say), and the
  caching host allocator would then record an event on the legacy default
  stream, which invalidates the capture.  A capture that fails raises:
  there is no fallback to an eager run.

The kernel wrappers count launches on the host when they run
(``kernels.ops``), which a replay does not: each graph keeps the counts
its capture added and every replay adds them again, while the warm-up's
and the capture's own counts are taken back out, so the counters read as
an eager run of the same calls would.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = ["GraphPool", "GraphSet", "WARMUP", "addresses", "upload"]

#: eager runs on the side stream before each capture
WARMUP = 2


def addresses(tensors) -> Tuple:
    """What a captured graph replays: each tensor's address and shape."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors)


def upload(arrays: Sequence[np.ndarray], bufs, device: torch.device) -> None:
    """Host arrays into their device buffers: on a CUDA device through
    pinned buffers of PyTorch's caching host allocator, which keeps each
    until its copy, queued on the current stream, has run -- the host
    never waits."""
    for a, b in zip(arrays, bufs):
        if not a.size:
            continue
        src = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            src = pinned
        b.copy_(src, non_blocking=True)


class GraphPool:
    """One private graph memory pool and one side stream on ``device``,
    shared by a strategy's graph sets."""

    def __init__(self, device: torch.device):
        self.device = device
        self._handle = None
        self._side = None
        #: graphs alive in the pool, over every set
        self.graphs = 0
        #: bytes the captures into the current pool took
        self.bytes = 0

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def side(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def dropped(self, n: int) -> None:
        """``n`` graphs were dropped; with none left the handle goes (a
        pool whose graphs all died is never captured into again)."""
        self.graphs -= n
        if self.graphs == 0:
            self._handle = None
            self.bytes = 0


class GraphSet:
    """The captured graphs of one kind, keyed by bucket, in a shared
    ``GraphPool``."""

    def __init__(self, pool: GraphPool):
        self.pool = pool
        #: key -> (graph, its outputs, the launch counts its capture added)
        self._graphs: Dict[Hashable, Tuple] = {}
        self._sig = None
        #: captures and replays per key, recaptures after a moved address
        self.captures: Dict[Hashable, int] = {}
        self.replays: Dict[Hashable, int] = {}
        self.recaptures = 0
        #: bytes this set's captures took from the pool, seconds of capture
        self.pool_bytes = 0
        self.capture_s = 0.0

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def check(self, tensors) -> None:
        """Drop every graph if ``tensors`` moved since the last check."""
        sig = addresses(tensors)
        if sig != self._sig:
            if self._graphs:
                self.recaptures += 1
                self.release()
            self._sig = sig

    def capture(self, key, warm: Callable[[], object],
                body: Callable[[], object], warmup: int = WARMUP) -> None:
        """``warm()`` ``warmup`` times on the side stream, then ``body()``
        captured there as ``key``'s graph; its return value is the
        graph's output."""
        t0 = time.perf_counter()
        dev = self.pool.device
        side = self.pool.side()
        cur = torch.cuda.current_stream(dev)
        before = ops.launch_counts()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                warm()
        cur.wait_stream(side)
        warm_counts = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle(),
                                  stream=side):
                out = body()
        finally:
            if collecting:
                gc.enable()
        grew = torch.cuda.memory_reserved(dev) - reserved
        self.pool_bytes += grew
        self.pool.bytes += grew
        self.pool.graphs += 1
        after = ops.launch_counts()
        ops.add_launch_counts({k: before[k] - after[k] for k in after})
        self._graphs[key] = (graph, out,
                             {k: after[k] - warm_counts[k] for k in after})
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s += time.perf_counter() - t0

    def replay(self, key):
        """Replay ``key``'s graph on the current stream; returns its
        outputs (static: clone what must outlive the next replay)."""
        graph, out, launches = self._graphs[key]
        graph.replay()
        ops.add_launch_counts(launches)
        self.replays[key] = self.replays.get(key, 0) + 1
        return out

    def release(self) -> None:
        """Drop every graph and its outputs (the pool's memory returns to
        the card once PyTorch's cache is emptied and no set holds a
        graph)."""
        n = len(self._graphs)
        self._graphs.clear()
        self.pool_bytes = 0
        if n:
            self.pool.dropped(n)

    def stats(self, name: Callable[[Hashable], Hashable] = lambda k: k
              ) -> Dict[str, object]:
        """Captures per key (named by ``name``), recaptures, replays in
        all, this set's pool bytes and its capture seconds."""
        return {"captures": {name(k): n
                             for k, n in sorted(self.captures.items())},
                "recaptures": self.recaptures,
                "replays": sum(self.replays.values()),
                "pool_bytes": self.pool_bytes, "capture_s": self.capture_s}
