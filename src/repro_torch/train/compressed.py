"""Train step with the int8 error-feedback gradient sync.

Counterpart of ``repro.train.compressed``, in its two stages:

1. each rank takes the gradient of ITS OWN microbatch (its rows of the
   batch) with ``model.loss`` -- the shard's mean, so the step's loss is
   the mean of the shards' losses, as the reference's
   ``jnp.mean(losses)``;
2. the sync: the flat float32 gradient (``optim.compression``'s layout)
   is averaged exactly over ``data`` and then synced in int8 with error
   feedback over ``pod`` when the mesh has a pod axis (the slow hop is
   the one worth compressing); without one, the int8 sync runs over the
   batch axes.  Then AdamW on the whole averaged gradient.

Each rank keeps one residual (the reference's ``(n_dp_shards, L)``
array sharded over the batch axes, one row per rank).

On a model axis above 1 the reference keeps Megatron inside the loss:
here stage 1 is the mesh train step's Megatron (each model rank takes
1 / tp of its shard's loss, the collectives' adjoints in the backward
pass, sequence parallelism by default) and its gradient shares are
summed over ``model`` only (``launch.steps._sum_grads``), giving each
rank its shard's gradient of its model pieces.  The flat vector, the
residual and the int8 sync are per model piece; the clip norm counts
each piece once (``launch.steps.grad_norm``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.launch.steps import (Step, _grads_of, _seq_sizes,
                                      _sum_grads, _train_setup, batch_to,
                                      grad_norm, opt_shardings)
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compression as C
from repro_torch.tree import leaves as tree_leaves


def residual_size(params) -> int:
    """Length of the flat residual of a parameter tree (each leaf padded
    to a multiple of ``BLOCK``)."""
    n = 0
    for leaf in tree_leaves(params):
        size = leaf.numel()
        n += size + ((-size) % C.BLOCK)
    return n


def init_residual(params, mesh: Mesh) -> torch.Tensor:
    """This rank's zero error-feedback buffer, float32 on its device,
    for ``params`` as it holds them (its model pieces)."""
    return torch.zeros(residual_size(params), dtype=torch.float32,
                       device=mesh.device)


def build_compressed_train_step(model, mesh: Mesh,
                                opt_cfg: OPT.AdamWConfig, *,
                                rules: Optional[Dict[str, Any]] = None,
                                remat: bool = True) -> Step:
    """step(params, opt_state, residual, batch) -> (params, opt_state,
    residual, metrics): ``batch`` is this rank's rows, ``residual`` its
    buffer (``init_residual``); params (this rank's model pieces, whole
    on a model axis of 1: ``in_shardings[0]``) and moments are updated
    in place."""
    rules, pshard = _train_setup(model, mesh, rules)
    bax = batch_axes(mesh)
    tp = mesh.shape.get("model", 1)
    pshapes, _ = model.param_specs()
    oshard = opt_shardings(mesh, pshard, pshapes, zero1=False)

    def shard_loss(params, b):
        loss, mets = model.loss(params, b, remat=remat)
        return (loss / tp if tp > 1 else loss), mets

    def train_step(params, opt_state, residual, batch):
        b = batch_to(batch, mesh.device)
        # ---- stage 1: this shard's gradient (of this rank's pieces) ----
        with SH.use_rules(mesh, rules, _seq_sizes(mesh, b)):
            (_, mets), grads = _grads_of(params, lambda: shard_loss(params,
                                                                    b))
        loss = mets["nll"]                  # the shard's loss, unscaled
        _sum_grads(mesh, grads, pshard, batch=False)
        vec, unflatten, shapes = C.flatten_tree(grads)
        del grads
        # ---- stage 2: exact mean over data, int8 over pod (or over the
        # batch axes when there is no pod axis) ----
        if "pod" in bax and len(bax) > 1:
            inner = tuple(a for a in bax if a != "pod")
            vec = mesh.all_reduce(vec, inner).div_(mesh.axis_size(inner))
            mean_vec, residual = C.sync_mean(vec, residual, mesh, ("pod",))
        else:
            mean_vec, residual = C.sync_mean(vec, residual, mesh, bax)
        grads = C.unflatten_tree(mean_vec, unflatten, shapes)
        params, opt_state, om = OPT.apply_updates(
            opt_cfg, params, grads, opt_state,
            gnorm=grad_norm(mesh, grads, pshard))
        mean_loss = mesh.all_reduce(loss.detach().reshape(1).clone(),
                                    bax)[0] / mesh.axis_size(bax)
        return params, opt_state, residual, {"loss": mean_loss, **om}

    return Step(train_step, mesh.device, mesh, rules, (pshard, oshard))
