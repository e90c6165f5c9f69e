"""The one-device train step as one captured CUDA graph per batch signature.

Counterpart of the reference's jitted train step
(``repro.launch.steps.build_train_step``: one XLA program, the parameters
and moments donated), which dispatches the whole step -- forward,
backward with ``remat``, the clip norm and the AdamW update -- as one
executable.  Eagerly the host issues every launch of every step; here
the step is recorded once into a ``torch.cuda.CUDAGraph`` and each later
step is one replay.

``TrainStepGraphs(body, device, graph=...)`` wraps
``body(params, opt_state, batch_on_device) -> (params, opt_state,
metrics)``, which updates the parameters, the moments and the step
counter in place (``optim.adamw.apply_updates``).  With ``graph=True``
(CUDA only):

* the batch's arrays are copied into static device buffers, one set per
  batch signature (the dict's keys, shapes and dtypes: Whisper's
  ``frames`` and a VLM's ``image_embeds`` too), through pinned host
  memory on the current stream, never waiting for the host;
* the first ``GRAPH_WARM`` calls of a signature run ``body`` eagerly on
  a side stream over those buffers -- real steps, so no warm-up advances
  the optimizer by accident -- which builds the kernel libraries and
  sets up cuBLAS and autograd on that stream;
* the next call captures ``body`` on the side stream into one graph (all
  graphs in one private pool), with Python's cycle collector off and in
  ``"thread_local"`` capture mode: the data pipeline's prefetch thread
  may touch the card meanwhile (``MemmapTokens`` reads its index there
  and waits for it), which the default ``"global"`` mode would count as
  a fault of the capture.  Capture records without running, so the call
  then replays once; every later call replays;
* the graph replays the addresses it captured: the parameters, the
  moments and the step counter are compared by address and shape with
  those at capture before each replay, and where one moved every graph
  is dropped and the step captured again (``recaptures``) -- never a
  replay over stale addresses;
* the metrics come back as fresh 0-d clones of the graph's outputs;
* the kernel wrappers count launches on the host when they run, which a
  replay does not: each graph keeps the counts its capture added, every
  replay adds them again, and the capture's own are taken back out, so
  ``ops.launch_counts()`` reads as an eager run of the same steps would.

A capture that fails raises: there is no fallback to the eager step.
With ``graph=False`` (the CPU's only mode) ``body`` runs eagerly on the
current stream over the batch moved to the device.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serve.graphs import addresses, upload
from repro_torch.tree import leaves

__all__ = ["GRAPH_WARM", "TrainStepGraphs"]

#: eager steps of each batch signature on the side stream before its capture
GRAPH_WARM = 2


def _signature(batch: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, np.shape(v), np.asarray(v).dtype.str)
                        for k, v in batch.items()))


class TrainStepGraphs:
    """A one-device train step replayed from one CUDA graph per batch
    signature (``graph=True``, CUDA only) or run eagerly."""

    def __init__(self, body, device: torch.device, *, graph: bool):
        if graph and device.type != "cuda":
            raise ValueError(f"a captured train step needs a CUDA device, "
                             f"got {device}; pass graph=False")
        self.body = body
        self.device = device
        self.graph = graph
        #: signature -> static device buffers of the batch
        self._inputs: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        #: signature -> (graph, its metrics, the launch counts its
        #: capture added)
        self._graphs: Dict[Tuple, Tuple] = {}
        self._warm: Dict[Tuple, int] = {}
        self._addrs = None
        self._pool = None
        self._side = None
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.eager_steps = 0
        #: bytes the graphs' private pool took, and seconds of capture
        self.pool_bytes = 0
        self.capture_s = 0.0

    # -- static inputs --
    def _buffers(self, sig: Tuple, batch) -> Dict[str, torch.Tensor]:
        if sig not in self._inputs:
            self._inputs[sig] = {
                k: torch.empty(np.shape(v), device=self.device,
                               dtype=torch.from_numpy(np.asarray(v)).dtype)
                for k, v in batch.items()}
        return self._inputs[sig]

    def _upload(self, batch, bufs: Dict[str, torch.Tensor]) -> None:
        """The numpy batch into its static buffers (``upload``)."""
        upload([np.asarray(batch[k]) for k in bufs], list(bufs.values()),
               self.device)

    # -- the step --
    def __call__(self, params, opt_state, batch):
        if not self.graph:
            self.eager_steps += 1
            return self.body(params, opt_state, {
                k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()})
        sig = _signature(batch)
        bufs = self._buffers(sig, batch)
        self._upload(batch, bufs)
        addrs = addresses(leaves(params) + leaves(opt_state.mu)
                           + leaves(opt_state.nu) + [opt_state.step])
        if addrs != self._addrs:
            if self._graphs:
                self.recaptures += 1
                self.release()
            self._addrs = addrs
        if sig not in self._graphs:
            if self._warm.get(sig, 0) < GRAPH_WARM:
                self._warm[sig] = self._warm.get(sig, 0) + 1
                return self._eager(params, opt_state, bufs)
            self._capture(params, opt_state, bufs, sig)
        graph, out, launches = self._graphs[sig]
        graph.replay()
        ops.add_launch_counts(launches)
        self.replays += 1
        return params, opt_state, {k: t.clone() for k, t in out.items()}

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _eager(self, params, opt_state, bufs):
        """One real step on the side stream over the static buffers."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            params, opt_state, mets = self.body(params, opt_state, bufs)
        cur.wait_stream(side)
        self.eager_steps += 1
        return params, opt_state, mets

    def _capture(self, params, opt_state, bufs, sig: Tuple) -> None:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                _, _, out = self.body(params, opt_state, bufs)
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        after = ops.launch_counts()
        added = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts({k: -n for k, n in added.items()})
        self._graphs[sig] = (graph, out, added)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def release(self) -> None:
        """Drop every graph and its outputs (the pool's memory returns to
        the card once PyTorch's cache is emptied)."""
        self._graphs.clear()
        self._pool = None
        self.pool_bytes = 0

    def stats(self) -> Dict[str, object]:
        return {"graph": self.graph, "captures": self.captures,
                "recaptures": self.recaptures, "replays": self.replays,
                "eager_steps": self.eager_steps,
                "pool_bytes": self.pool_bytes, "capture_s": self.capture_s}
