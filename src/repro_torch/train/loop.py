"""Fault-tolerant training loop.

Counterpart of ``repro.train.loop``:
  * resume: the loop starts from ``checkpoint.latest_step`` and the data
    pipeline is step-addressable, so a killed job restarted with the
    same config reproduces the uninterrupted run bit for bit (on the
    card too, where every op of the step has a deterministic backward
    pass: ``launch/steps.py``); the restored leaves are copied into the
    parameters, moments and step counter passed in, so their addresses
    -- which a captured train step replays -- do not move;
  * periodic block-based checkpoints (atomic, keep-last-k), and one at
    the end;
  * straggler monitor: per-step wall times feed an EWMA watermark; steps
    slower than ``straggler_factor`` x the watermark are counted and
    handed to ``on_straggler``, and left out of the watermark;
  * NaN/overflow guard: a non-finite loss saves a checkpoint and raises
    ``FloatingPointError`` rather than training on;
  * under a mesh (a step built with ``mesh=``, data and model axes):
    every rank draws the global batch and takes its rows
    (``launch.steps.shard_batch``); a checkpoint holds whole leaves, the
    model pieces and ZeRO-1's moment slices glued on every rank, written
    by rank 0 while the others wait (``checkpoint.save(shardings=)``); a
    resume reads the whole leaves on every rank and cuts this rank's
    pieces again (``checkpoint.restore(shardings=)``).  The loss is the
    global one on every rank, so every rank takes the same decisions;
  * ``ckpt_every`` 0 writes no checkpoint at all (a timed run).

The step's wall time is host time around a step that ends by reading
its loss, which waits for the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.data.pipeline import DataConfig, PrefetchIterator, make_source
from repro_torch.launch import steps as STEPS
from repro_torch.train import checkpoint as CKPT
from repro_torch.tree import leaves as tree_leaves


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "repro_ckpt"
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma: float = 0.9


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    ewma: float = 0.9
    watermark: Optional[float] = None
    n_stragglers: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if self.watermark is not None and dt > self.factor * self.watermark:
            self.n_stragglers += 1
            slow = True
            if self.on_straggler:
                self.on_straggler(step, dt, self.watermark)
        # the EWMA leaves straggler samples out, so one hiccup does not
        # poison the baseline
        if self.watermark is None:
            self.watermark = dt
        elif not slow:
            self.watermark = self.ewma * self.watermark + (1 - self.ewma) * dt
        return slow


def run(step_fn, params, opt_state, data_cfg: DataConfig,
        loop_cfg: TrainLoopConfig, *, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    with ``metrics["loss"]``; ``batch`` is the pipeline's numpy dict.

    Restores ``{"params", "opt"}`` onto the devices of ``params`` and
    ``opt_state`` when ``loop_cfg.ckpt_dir`` holds a checkpoint; a
    ``memmap`` source keeps its index on ``device``.  Returns {"params",
    "opt_state", "losses", "stragglers"}."""
    mesh = getattr(step_fn, "mesh", None)
    if mesh is not None:
        pshard, oshard = step_fn.in_shardings
        if mesh.rank != 0:
            log = _quiet

    def save(step):
        state = {"params": params, "opt": opt_state}
        if mesh is None:
            CKPT.save(loop_cfg.ckpt_dir, step, state,
                      keep_last=loop_cfg.keep_last)
            return
        CKPT.save(loop_cfg.ckpt_dir, step, state,
                  keep_last=loop_cfg.keep_last, mesh=mesh,
                  shardings={"params": pshard, "opt": oshard})
        mesh.barrier()

    start = CKPT.latest_step(loop_cfg.ckpt_dir)
    if start is not None:
        like = {"params": params, "opt": opt_state}
        state = (CKPT.restore(loop_cfg.ckpt_dir, start, like) if mesh is None
                 else CKPT.restore(loop_cfg.ckpt_dir, start, like,
                                   shardings={"params": pshard,
                                              "opt": oshard}, mesh=mesh))
        # into the tensors passed in, so a step that captured their
        # addresses (``train/step_graph.py``) stays valid
        with torch.no_grad():
            for dst, src in zip(tree_leaves(like), tree_leaves(state)):
                dst.copy_(src)
        log(f"[resume] restored step {start}")
        first = start
    else:
        first = 0

    src = make_source(data_cfg, device=device)
    it = PrefetchIterator(src, start_step=first)
    mon = StragglerMonitor(loop_cfg.straggler_factor, loop_cfg.ewma)
    losses = []
    try:
        for _ in range(first, loop_cfg.total_steps):
            step, batch = next(it)
            if mesh is not None:
                batch = STEPS.shard_batch(mesh, batch)
            t0 = time.perf_counter()
            params, opt_state, mets = step_fn(params, opt_state, batch)
            loss = float(mets["loss"])
            dt = time.perf_counter() - t0
            mon.observe(step, dt)
            losses.append(loss)
            if not math.isfinite(loss):
                if loop_cfg.ckpt_every > 0:
                    save(step)
                raise FloatingPointError(f"non-finite loss at step {step}")
            done = step + 1
            if done % loop_cfg.log_every == 0:
                gn = mets.get("grad_norm")
                log(f"[step {done}] loss={loss:.6f} "
                    + (f"grad_norm={float(gn):.6f} " if gn is not None
                       else "")
                    + f"dt={dt*1e3:.1f}ms stragglers={mon.n_stragglers}")
            if loop_cfg.ckpt_every > 0 and (
                    done % loop_cfg.ckpt_every == 0
                    or done == loop_cfg.total_steps):
                save(done)
    finally:
        it.close()
    return {"params": params, "opt_state": opt_state,
            "losses": losses, "stragglers": mon.n_stragglers}


def _quiet(msg: str) -> None:
    """The log of a rank other than 0: nothing."""
