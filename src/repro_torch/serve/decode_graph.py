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
  needs its bucket and replayed at every later one, in the memory pool
  the strategy's graphs share (``serve/graphs.py``: the prefill buckets'
  graphs live there too).

A step writes the host's update arrays into the bucket's buffers (from
pinned memory, non-blocking, on the current stream), copies the token
vector into the static one, replays the graph and returns a clone of its
output: each call hands back a fresh tensor, which the engine latches as
the next step's input.

A graph replays the addresses it captured.  Before each replay the
tensors the tail reads or writes besides its buffers -- the parameters,
the pools and the resident tables, lengths and rows -- are compared by
address and shape with those at capture; where one changed, every decode
graph of the strategy is dropped and captured again, and ``recaptures``
counts it.  The warm-up before each capture runs the tail against idle
copies of the resident tensors and all-pad updates, so that every write
of the warm-up lands in the sink block, the sink state row or a scratch
row.  Capture, the shared pool and side stream and the launch-count
bookkeeping are ``serve/graphs.py``'s.

On the CPU, and with ``graphs=False`` (``Engine(graphs=False)``),
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

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.graphs import GraphPool, GraphSet, upload
from repro_torch.tree import leaves

__all__ = ["DecodeGraphs"]


class DecodeGraphs:
    """One strategy's static-buffer decode tail, replayed from one CUDA
    graph per update width ``W`` (``graphs=True`` on a CUDA device) or
    run eagerly on the same buffers.  ``pool`` is the strategy's shared
    ``GraphPool`` (a pool of its own when None)."""

    def __init__(self, slots: int, device: torch.device, *,
                 graphs: bool = True, pool: Optional[GraphPool] = None):
        self.slots = slots
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self.tokens = torch.zeros(slots, dtype=torch.long, device=device)
        self._inputs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._set = GraphSet(pool if pool is not None else GraphPool(device))

    @property
    def captures(self) -> Dict[int, int]:
        """Captures per bucket."""
        return self._set.captures

    @property
    def replays(self) -> int:
        """Replays in all."""
        return sum(self._set.replays.values())

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
        self._set.check(leaves(params) + list(strategy._pools())
                        + list(strategy._resident))
        W = len(upd[0])
        if W not in self._set:
            res, pad = self._idle(strategy, W)
            self._set.capture(
                W, lambda: strategy._tail(params, self.tokens, res, pad),
                lambda: strategy._tail(params, self.tokens,
                                       strategy._resident, bufs))
            del res, pad
        return self._set.replay(W).clone()

    def release(self) -> None:
        """Drop every graph and its output (the pool's memory returns to
        the card once PyTorch's cache is emptied)."""
        self._set.release()

    @property
    def stats(self) -> Dict[str, object]:
        return {"graphs": self.graphs, **self._set.stats()}
