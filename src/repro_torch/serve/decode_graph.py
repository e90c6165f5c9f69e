"""The resident decode tail as one captured CUDA graph per update width.

Counterpart of the reference's jitted, buffer-donated decode tails
(``DecoderLM.decode_fused`` through ``_jitted``, the constant-state and
composite strategies' ``_fused_fn``): each is traced once per
power-of-two update width ``W`` (``CacheStrategy._bucket``), and
steady-state decode is one dispatch into a warm executable.  Here each
strategy owns one ``DecodeGraphs``, which holds

* static input buffers: the token vector ``(slots,)`` and, per bucket,
  the update arrays of width ``W`` (pads included: a pad's slot is
  ``slots``, the resident tensors' scratch row, so the splice drops it on
  the device without a data-dependent shape);
* one ``torch.cuda.CUDAGraph`` per ``W``, captured at the first step that
  needs its bucket and replayed at every later one, all of a strategy's
  graphs in one memory pool (``torch.cuda.graph_pool_handle``).

A step writes the host's update arrays into the bucket's buffers (from
pinned memory, non-blocking, on the current stream), copies the token
vector into the static one, replays the graph and returns a clone of its
output: each call hands back a fresh tensor, which the engine latches as
the next step's input.

A graph replays the addresses it captured.  Before each replay the
tensors the tail reads or writes besides its buffers -- the parameters,
the pools and the resident tables, lengths and rows -- are compared by
address and shape with those at capture; where one changed (the transfer
plane may rebind a pool through its executor), every graph of the
strategy is dropped and captured again, and ``recaptures`` counts it.

Capture follows PyTorch's recipe: the tail first runs eagerly
``WARMUP`` times on a side stream -- which builds the kernel libraries
and sets up cuBLAS on that stream -- against idle copies of the resident
tensors and all-pad updates, so that every write of the warm-up lands in
the sink block, the sink state row or a scratch row; then the capture
records the tail on the same stream, with Python's cycle collector off:
a collection inside the capture could free a pinned host buffer that a
copy on the default stream used (a swap-in's payload, say), and the
caching host allocator would then record an event on the legacy default
stream, which invalidates the capture.  A capture that fails raises:
there is no fallback to the eager tail.

The kernel wrappers count launches on the host when they run
(``kernels.ops``), which a replay does not: each graph keeps the counts
its capture added and every replay adds them again, while the warm-up's
and the capture's own counts are taken back out, so the counters read
as an eager run of the same steps would.

On the CPU, and with ``graphs=False`` (``Engine(decode_graphs=False)``),
the same tail runs eagerly on the same static buffers.

A strategy provides:

* ``_resident``: the tuple of resident tensors the splice writes, each
  with ``slots + 1`` rows (the last is the scratch row);
* ``_pad_update(W)``: the host update arrays of width ``W``, all pads --
  the slot vector, then one array per resident tensor whose pad value is
  that tensor's idle value (the sink, length 0, the sink state row);
* ``_pools()``: the pools the tail reads and writes;
* ``_tail(params, tokens, resident, upd)``: splice ``upd`` into
  ``resident``, decode one step and return the ``(slots,)`` argmax.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import leaves

__all__ = ["DecodeGraphs", "addresses", "upload"]

#: eager runs of the tail on the side stream before each capture
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


class DecodeGraphs:
    """One strategy's static-buffer decode tail, replayed from one CUDA
    graph per update width ``W`` (``graphs=True`` on a CUDA device) or
    run eagerly on the same buffers."""

    def __init__(self, slots: int, device: torch.device, *,
                 graphs: bool = True):
        self.slots = slots
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self.tokens = torch.zeros(slots, dtype=torch.long, device=device)
        self._inputs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        #: W -> (graph, its output, the launch counts its capture added)
        self._graphs: Dict[int, Tuple] = {}
        self._sig = None
        self._pool = None
        self._side = None
        #: captures per bucket, recaptures after a moved address, replays
        self.captures: Dict[int, int] = {}
        self.recaptures = 0
        self.replays = 0
        #: bytes the graphs' private pool took, and seconds of capture
        self.pool_bytes = 0
        self.capture_s = 0.0

    # -- static inputs --
    def _buffers(self, upd: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """The static device buffers of ``upd``'s width, made at its first
        use."""
        W = len(upd[0])
        if W not in self._inputs:
            self._inputs[W] = tuple(
                torch.empty(a.shape, device=self.device,
                            dtype=torch.from_numpy(a).dtype) for a in upd)
        return self._inputs[W]

    def _idle(self, strategy, W: int):
        """Idle resident tensors (every slot empty) and all-pad updates of
        width ``W``, on the device: the warm-up's inputs."""
        res = tuple(torch.from_numpy(a).to(device=r.device, dtype=r.dtype)
                    for a, r in zip(strategy._pad_update(self.slots + 1)[1:],
                                    strategy._resident))
        upd = tuple(torch.from_numpy(a).to(self.device)
                    for a in strategy._pad_update(W))
        return res, upd

    # -- the step --
    def run(self, strategy, params, tokens: torch.Tensor,
            upd: Sequence[np.ndarray]) -> torch.Tensor:
        """One decode tail of ``strategy`` on ``tokens`` with the host
        update arrays ``upd``; returns a fresh ``(slots,)`` next-token
        tensor on the device."""
        bufs = self._buffers(upd)
        upload(upd, bufs, self.device)
        self.tokens.copy_(tokens)
        if not self.graphs:
            return strategy._tail(params, self.tokens, strategy._resident,
                                  bufs)
        sig = addresses(leaves(params) + list(strategy._pools())
                         + list(strategy._resident))
        if sig != self._sig:
            if self._graphs:
                self.recaptures += 1
                self.release()
            self._sig = sig
        W = len(upd[0])
        if W not in self._graphs:
            self._capture(strategy, params, W, bufs)
        graph, out, launches = self._graphs[W]
        graph.replay()
        ops.add_launch_counts(launches)
        self.replays += 1
        return out.clone()

    def _capture(self, strategy, params, W: int, bufs) -> None:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        before = ops.launch_counts()
        res, upd = self._idle(strategy, W)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            for _ in range(WARMUP):
                strategy._tail(params, self.tokens, res, upd)
        torch.cuda.current_stream(self.device).wait_stream(self._side)
        del res, upd
        warm = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side):
                out = strategy._tail(params, self.tokens,
                                     strategy._resident, bufs)
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        after = ops.launch_counts()
        ops.add_launch_counts({k: before[k] - after[k] for k in after})
        self._graphs[W] = (graph, out,
                           {k: after[k] - warm[k] for k in after})
        self.captures[W] = self.captures.get(W, 0) + 1
        self.capture_s += time.perf_counter() - t0

    def release(self) -> None:
        """Drop every graph and its output (the pool's memory returns to
        the card once PyTorch's cache is emptied)."""
        self._graphs.clear()
        self._pool = None
        self.pool_bytes = 0

    @property
    def stats(self) -> Dict[str, object]:
        return {"graphs": self.graphs, "captures": dict(self.captures),
                "recaptures": self.recaptures, "replays": self.replays,
                "pool_bytes": self.pool_bytes,
                "capture_s": self.capture_s}
