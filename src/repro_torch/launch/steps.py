"""Train and forward steps for one device.

Counterpart of ``repro.launch.steps``' ``build_train_step`` and
``build_forward_step`` on one card: no mesh, no shardings and no
donation.  The serve and prefill step builders, the sharding rules and
ZeRO-1 wait for the sharding slice.

A train step is the reference's ``jax.value_and_grad(model.loss)`` then
``adamw.apply_updates``, eagerly: the numpy batch moves to the device,
the parameter leaves are marked ``requires_grad`` for the step,
``loss.backward()`` fills their ``.grad``, AdamW updates them in place
under ``no_grad``, and the ``.grad`` are dropped again.  Every op of the
loss has a deterministic CUDA backward pass (the embedding and target
gathers are indexing whose CUDA backward sorts its indices, the
stacked layers are split by ``unbind``), so equal inputs give equal
bits and a resumed run equals the uninterrupted one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adamw as OPT
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Step:
    """A step function bound to its device: ``step(*args)``."""
    fn: Callable
    device: torch.device

    def __call__(self, *args):
        return self.fn(*args)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def build_train_step(model, opt_cfg: OPT.AdamWConfig, *, remat: bool = True,
                     device="cuda") -> Step:
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    params and moments updated in place; metrics hold the loss's
    metrics, ``grad_norm``, ``lr`` and ``loss`` as 0-d device tensors."""
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        b = batch_to(batch, dev)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, mets = model.loss(params, b, remat=remat)
            loss.backward()
            grads = tree_map(lambda t: t.grad if t.grad is not None
                             else torch.zeros_like(t), params)
            params, opt_state, om = OPT.apply_updates(opt_cfg, params, grads,
                                                      opt_state)
        finally:
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
        mets = {k: v.detach() for k, v in mets.items()}
        return params, opt_state, {**mets, **om, "loss": loss.detach()}

    return Step(train_step, dev)


def build_forward_step(model, *, remat: bool = False, device="cuda") -> Step:
    """step(params, batch) -> (loss, metrics), no gradient."""
    dev = resolve_device(device)

    def fwd(params, batch):
        with torch.no_grad():
            return model.loss(params, batch_to(batch, dev), remat=remat)

    return Step(fwd, dev)
