"""The paged prefill and suffix prefill as one captured CUDA graph per
``(B, S)`` bucket.

Counterpart of the reference's ``DecoderLM._jitted("prefill" |
"prefill_suffix")`` cache: ``DecoderLM.prefill`` is "jit-cached per (B,
S) bucket" and ``prefill_suffix`` "per (B, SQ) bucket", and a bucket met
again is one dispatch into a warm executable.  Here each
``PagedKVStrategy`` owns one ``PrefillGraphs``, keyed by ``(kind, B,
S)`` with ``kind`` ``"prefill"`` or ``"suffix"`` and B, S the shapes the
strategy already builds (the reference's own keys: the batch's rows and
its longest prompt rounded up to a block; the suffix's power-of-two
block count).  Per key it holds

* static input buffers, made at the key's first sighting and reused
  after: the tokens ``(B, S)``, the prefill tables ``(B,
  max_blocks_per_seq)`` and the lengths ``(B,)``; for ``"suffix"`` also
  the starts ``(B,)`` and the write tables ``(B, S // block_tokens)``.
  The host fills them through ``graphs.upload`` (pinned, non-blocking);
* from the ``CAPTURE_AT``-th sighting on, one ``torch.cuda.CUDAGraph``,
  in the memory pool and on the side stream that the strategy's decode
  graphs use (``serve/graphs.py``).

A call uploads the host's arrays into the key's buffers and counts a
sighting.  Before ``CAPTURE_AT`` sightings the body runs eagerly on the
buffers (a bucket met once in a run is never captured: its capture would
buy nothing); at the ``CAPTURE_AT``-th the body is captured -- its
``PREFILL_WARMUP`` warm-up runs go on all-pad inputs (sink tables and
write tables, never ``NULL_BLOCK``, which ``write_prefill`` clamps to the
live block 0), so every write of the warm-up lands in the sink block --
and then replayed, as at every later sighting.  The body builds the ``PagedKVCache`` view
over the strategy's pools and the static tables and lengths, runs
``model.prefill`` or ``model.prefill_suffix`` and takes the argmax: it
syncs nothing on the host and reads no shape from a tensor's values.  A
call returns a fresh ``(B,)`` argmax and leaves the last logits in
``last`` (after a replay the graph's static output, in the pool the
strategy's graphs share: valid until any of them replays or is
captured); the strategy's ``.cpu()`` of the argmax stays
outside the graph, so time to first token still ends when the host
holds the token.

The parameters and the pools are compared by address and shape before
each replay, and where one moved every prefill graph is dropped and each
bucket is captured again at its next sighting (``recaptures``).  A
capture that fails raises: on the card the eager prefill runs only
before a bucket's ``CAPTURE_AT``-th sighting, or with ``graphs=False``
(``Engine(graphs=False)``, which turns the decode graphs off too).  On
the CPU the same body runs eagerly on the same buffers at every
sighting.

A strategy provides ``_pools()``, ``_prefill_pad(kind, B, S)`` (the
host arrays of a bucket, all pads: tokens 0, tables and write tables all
sink, lengths S, starts 0) and ``_prefill_body(params, kind, bufs)``
(returns ``(argmax (B,), last logits (B, V))``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.graphs import GraphPool, GraphSet, upload
from repro_torch.tree import leaves

__all__ = ["CAPTURE_AT", "PREFILL_WARMUP", "PrefillGraphs", "bucket_name"]

#: the sighting of a bucket at which it is captured: a bucket met once
#: in a run is never captured (its capture would buy nothing)
CAPTURE_AT = 2
#: eager runs of a bucket on the side stream before its capture: one,
#: since its earlier sightings already ran the body eagerly (a 62-layer
#: prefill's run costs the host a quarter of a second)
PREFILL_WARMUP = 1


def bucket_name(key: Tuple[str, int, int]) -> str:
    """``("prefill", 1, 192)`` -> ``"prefill 1x192"``."""
    kind, B, S = key
    return f"{kind} {B}x{S}"


class PrefillGraphs:
    """One strategy's prefill buckets: static buffers per ``(kind, B,
    S)``, replayed from one CUDA graph per bucket from its
    ``CAPTURE_AT``-th sighting on (``graphs=True`` on a CUDA device) or
    run eagerly on the same buffers.  ``pool`` is the strategy's shared
    ``GraphPool`` (a pool of its own when None)."""

    def __init__(self, device: torch.device, *, graphs: bool = True,
                 pool: Optional[GraphPool] = None):
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self._inputs: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._set = GraphSet(pool if pool is not None else GraphPool(device))
        #: per key: calls and eager runs (captures and replays are the
        #: graph set's)
        self.sightings: Dict[Tuple, int] = {}
        self.eager: Dict[Tuple, int] = {}
        #: the last call's logits (B, V); after a replay the graph's
        #: static output, valid until any graph in the pool replays
        self.last: Optional[torch.Tensor] = None

    def _buffers(self, key, arrays: Sequence[np.ndarray]
                 ) -> Tuple[torch.Tensor, ...]:
        if key not in self._inputs:
            self._inputs[key] = tuple(
                torch.empty(a.shape, device=self.device,
                            dtype=torch.from_numpy(a).dtype) for a in arrays)
        return self._inputs[key]

    def run(self, strategy, params, kind: str,
            arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """One ``kind`` prefill of ``strategy`` on the host arrays
        ``arrays`` (tokens first); returns a fresh ``(B,)`` argmax on the
        device and keeps the logits in ``last``."""
        B, S = arrays[0].shape
        key = (kind, B, S)
        bufs = self._buffers(key, arrays)
        upload(arrays, bufs, self.device)
        n = self.sightings[key] = self.sightings.get(key, 0) + 1
        if self.graphs:
            self._set.check(leaves(params) + list(strategy._pools()))
            if key not in self._set and n >= CAPTURE_AT:
                pad = tuple(torch.from_numpy(a).to(self.device)
                            for a in strategy._prefill_pad(kind, B, S))
                self._set.capture(
                    key, lambda: strategy._prefill_body(params, kind, pad),
                    lambda: strategy._prefill_body(params, kind, bufs),
                    warmup=PREFILL_WARMUP)
                del pad
            if key in self._set:
                nxt, self.last = self._set.replay(key)
                return nxt.clone()
        self.eager[key] = self.eager.get(key, 0) + 1
        nxt, self.last = strategy._prefill_body(params, kind, bufs)
        return nxt

    def release(self) -> None:
        """Drop every graph and its outputs; the buffers and the
        sightings stay."""
        self._set.release()
        self.last = None

    @property
    def stats(self) -> Dict[str, object]:
        """Per bucket (``bucket_name``) its sightings, captures, replays
        and eager runs; recaptures, replays in all, this kind's pool bytes
        and capture seconds, and the bytes of the pool it shares."""
        buckets = {bucket_name(k): {
            "sightings": n, "captures": self._set.captures.get(k, 0),
            "replays": self._set.replays.get(k, 0),
            "eager": self.eager.get(k, 0)}
            for k, n in sorted(self.sightings.items())}
        return {"graphs": self.graphs, "buckets": buckets,
                **self._set.stats(bucket_name),
                "shared_pool_bytes": self._set.pool.bytes}
