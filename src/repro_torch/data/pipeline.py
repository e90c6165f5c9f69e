"""Deterministic, step-addressable data pipeline.

Counterpart of ``repro.data.pipeline``.  After a restart at step k the
pipeline must give exactly the batches the uninterrupted run would have
consumed, so a batch is a pure function of (seed, step), bit for bit the
reference's for the same config:

  * ``SyntheticLM`` -- the reference's numpy token streams (repeated
    16-token motifs over noise, so the loss falls);
  * ``MemmapTokens`` -- ``np.memmap`` over a flat int32 token file, its
    sequence index held in the paper's fixed-size blocks: a ``TreeArray``
    of 32 KB float32 leaves (float32 as in the reference, so the starts
    and the batches match), read with the naive page walk.

Both give numpy ``{"tokens", "targets"}`` (B, S) int32 with next-token
targets; the training step moves them to the card.  ``PrefetchIterator``
makes them one thread ahead.  The index lives on the ``device`` its
source was built for, which the prefetch thread reaches only through
that tensor.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.core.treearray import TreeArray


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None


def _step_rng(cfg: DataConfig, step: int) -> np.random.RandomState:
    return np.random.RandomState((cfg.seed * 1_000_003 + step) % 2**31)


class SyntheticLM:
    """Deterministic mixture of repeated n-grams + noise; batches are a
    pure function of (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.RandomState(cfg.seed)
        self._motifs = base.randint(
            0, cfg.vocab_size, size=(64, 16)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = _step_rng(cfg, step)
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        # overwrite most positions with repeated motifs => learnable signal
        for b in range(B):
            pos = 0
            while pos < S + 1 - 16:
                m = self._motifs[rng.randint(0, 64)]
                toks[b, pos: pos + 16] = m
                pos += 16 + rng.randint(0, 4)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class MemmapTokens:
    """Flat int32 token file + TreeArray-backed sequence index.

    The index (start offset of each sequence) lives in 32 KB TreeArray
    leaves on ``device`` -- no contiguous index allocation, per the
    paper."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        n_seqs = (len(self.tokens) - 1) // cfg.seq_len
        starts = (np.arange(n_seqs) * cfg.seq_len).astype(np.float32)
        self.index = TreeArray.from_dense(starts, leaf_size=8192,
                                          device=device)
        self.n_seqs = n_seqs

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = _step_rng(cfg, step)
        idx = rng.randint(0, self.n_seqs, size=cfg.global_batch)
        starts = self.index.get_naive(idx).cpu().numpy().astype(np.int64)
        out = np.stack([self.tokens[s: s + cfg.seq_len + 1]
                        for s in starts]).astype(np.int32)
        return {"tokens": out[:, :-1], "targets": out[:, 1:]}


def make_source(cfg: DataConfig, device="cuda"):
    """``MemmapTokens`` (its index on ``device``) for ``source="memmap"``,
    else ``SyntheticLM``."""
    if cfg.source == "memmap":
        return MemmapTokens(cfg, device=device)
    return SyntheticLM(cfg)


class PrefetchIterator:
    """Background-thread prefetch of ``depth`` steps, resumable at any
    step (the fault-tolerant loop hands it the restored step).
    ``next(it)`` gives ``(step, batch)``; ``close()`` stops the thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _fill(self):
        step = self._step
        try:
            while not self._stop.is_set():
                self._put((step, self.source.batch_at(step)))
                step += 1
        except Exception as e:          # handed to the consumer
            self._put((None, e))

    def __next__(self):
        step, batch = self._q.get()
        if step is None:
            raise batch
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join()
