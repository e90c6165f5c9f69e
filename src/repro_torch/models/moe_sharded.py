"""Mesh-aware MoE dispatch: the data axis.

Counterpart of ``repro.models.moe_sharded``'s ``moe_ffn_dispatch`` for a
mesh whose ``model`` axis is 1.  The reference runs the feed-forward in
``shard_map`` whenever a mesh is active so that each data shard routes
and sorts ITS OWN tokens (``_moe_tp_shardmap``), then takes the mean of
the shards' router aux losses (``pmean`` over the batch axes).  Here
every rank already holds only its rows, so the feed-forward is the
one-device ``moe_ffn`` on them, and the aux loss it returns is the
shard's own.  Its mean over the shards is taken by the mesh train step
(``launch/steps.py``), outside autograd: each rank's aux term enters its
gradient with weight 1/n before the gradients are summed, which is the
gradient of the mean.  No collective runs inside the forward or the
backward pass, so ranks that share one card (and one autograd device
thread) cannot wait on each other there.

The expert-parallel layout (``_moe_ep_shardmap``'s all-to-all) and the
``model``-sharded expert hidden dim come with the model axis.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as SH
from repro_torch.models.common import Params
from repro_torch.models.moe import moe_ffn


def moe_ffn_dispatch(lp: Params, x3d: torch.Tensor, cfg: ModelConfig, *,
                     with_aux: bool = False):
    """x3d (B, S, d) -> y (B, S, d), or (y, this shard's aux loss) with
    ``with_aux``.  Under an active mesh the rows are this rank's."""
    if SH.tp_size() > 1:
        raise NotImplementedError(
            f"{cfg.name}: the MoE feed-forward over a model axis of "
            f"{SH.tp_size()} (tensor or expert parallel) comes with the "
            f"model-axis slice (ROADMAP.md queue 1, item 2)")
    B, S, d = x3d.shape
    out = moe_ffn(lp, x3d.reshape(B * S, d), cfg, with_aux=with_aux)
    if with_aux:
        y, aux = out
        return y.reshape(B, S, d), aux
    return out.reshape(B, S, d)
