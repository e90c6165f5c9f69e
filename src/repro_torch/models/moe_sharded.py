"""Mesh-aware MoE dispatch: the data axis, and the model axis's two
expert layouts.

Counterpart of ``repro.models.moe_sharded``.  The reference runs the
feed-forward in ``shard_map`` whenever a mesh is active so that each
data shard routes and sorts ITS OWN tokens, then takes the mean of the
shards' router aux losses (``pmean`` over the batch axes).  Here every
rank already holds only its rows, so on a ``model`` axis of 1 the
feed-forward is the one-device ``moe_ffn`` on them, and the aux loss it
returns is the shard's own.  Its mean over the shards is taken by the
mesh train step (``launch/steps.py``), outside autograd: each rank's aux
term enters its gradient with weight 1/n before the gradients are
summed, which is the gradient of the mean.

On a ``model`` axis above 1 (the serve and prefill steps, under
``no_grad``) the feed-forward takes one of the reference's layouts
(``cfg.moe.parallel_mode``):

* ``tp`` (``_moe_tp_shardmap``): every rank routes the same tokens with
  the replicated float32 router and runs ``moe_ffn``'s arithmetic on its
  slice of each expert's hidden dim and of the shared experts, with the
  down-projections and the routed combine left in float32; the partial
  outputs are summed over ``model`` in float32 and rounded once
  (``moe_tp``), where one device rounds each down-projection, each
  weighted replica and each add of the combine.  A hidden dim the axis
  does not divide stays whole on every rank and is not summed;
* ``ep`` (``_moe_ep_shardmap``): a rank holds ``E / ep`` whole experts;
  each token replica is slotted into its expert's buffer of capacity
  ``C = int(T * top_k * cap) // E + 1`` (``cap`` the config's
  ``capacity_factor``, 1.25 when it is 0), replicas past ``C`` are
  dropped, and the buffers travel to the experts' owners and back by
  ``Mesh.all_to_all`` (``moe_ep``).  Capacity follows the token count of
  the data shard, and every model rank of a shard holds the same
  tokens, so the output equals ``moe_ep_local`` -- the same rule on one
  device with no exchange -- on that shard's rows.  The dropless
  ``moe_ffn`` is a different function (``ep_dropped`` counts the
  replicas ``moe_ep`` drops).

The router's aux loss stays each data shard's own in both layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as SH
from repro_torch.models.common import Params
from repro_torch.models.moe import (load_balance_loss, moe_ffn, route,
                                    routed_ffn, shared_ffn)


def moe_ffn_dispatch(lp: Params, x3d: torch.Tensor, cfg: ModelConfig, *,
                     with_aux: bool = False):
    """x3d (B, S, d) -> y (B, S, d), or (y, this shard's aux loss) with
    ``with_aux``.  Under an active mesh the rows are this rank's; on a
    model axis above 1, ``lp`` holds this rank's pieces of the layer's
    weights for ``cfg.moe.parallel_mode``'s layout."""
    B, S, d = x3d.shape
    x = x3d.reshape(B * S, d)
    if SH.model_mesh() is None:
        out = moe_ffn(lp, x, cfg, with_aux=with_aux)
    elif cfg.moe.parallel_mode == "ep":
        out = moe_ep(lp, x, cfg, with_aux=with_aux)
    else:
        out = moe_tp(lp, x, cfg, with_aux=with_aux)
    if with_aux:
        y, aux = out
        return y.reshape(B, S, d), aux
    return out.reshape(B, S, d)


def moe_tp(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
           with_aux: bool = False):
    """The ``tp`` layout on this rank's slices: x (T, d) -> y (T, d)
    (and the aux loss with ``with_aux``), the routed and the shared
    experts' partial outputs each summed over the model axis where
    their hidden dim is split."""
    e = cfg.moe
    weights, experts, probs = route(lp["router"], x, e)
    split = lp["wi"].shape[-1] != e.d_ff_expert
    y = routed_ffn(lp, x, cfg, weights, experts, f32=split)
    if split:
        y = SH.partial_sum(y)
    y = _add_shared(lp, x, y, e).to(x.dtype)
    if with_aux:
        return y, load_balance_loss(probs, experts, e)
    return y


def _add_shared(lp: Params, x: torch.Tensor, y: torch.Tensor, e
                ) -> torch.Tensor:
    """``y`` plus the shared experts' output of ``x``: this rank's
    float32 partial summed over the model axis where their hidden dim
    is split (unrounded; the caller rounds once)."""
    if not e.num_shared_experts:
        return y
    split = lp["shared_wi"].shape[-1] != e.d_ff_shared
    s = shared_ffn(lp, x, f32=split)
    return y + (SH.partial_sum(s) if split else s)


def _capacity(T: int, e) -> int:
    cap = e.capacity_factor if e.capacity_factor > 0 else 1.25
    return int(T * e.top_k * cap) // e.num_experts + 1


def _slots(experts: torch.Tensor, e, C: int):
    """The reference's slot rule: replicas sorted (stably) by expert,
    each ranked within its expert; (order, token of each sorted replica,
    its global slot ``expert * C + rank``, kept: rank < C)."""
    n = experts.numel()
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = order // e.top_k
    se = flat[order]
    pos = torch.arange(n, device=flat.device) - torch.searchsorted(se, se)
    return order, tok, se * C + pos, pos < C


def ep_dropped(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> int:
    """How many of the T * top_k replicas of ``x`` (T, d) the ``ep``
    layout drops at its capacity (a host read)."""
    e = cfg.moe
    _, experts, _ = route(lp["router"], x, e)
    _, _, _, keep = _slots(experts, e, _capacity(x.shape[0], e))
    return int((~keep).sum())


def _moe_ep(lp: Params, x: torch.Tensor, cfg: ModelConfig, exchange,
            ep: int, with_aux: bool):
    e = cfg.moe
    T, d = x.shape
    E = e.num_experts
    e_loc = lp["wi"].shape[0]
    if e_loc * ep != E:
        raise ValueError(f"{cfg.name}: {e_loc} experts a rank over {ep} "
                         f"ranks for {E} experts")
    weights, experts, probs = route(lp["router"], x, e)
    C = _capacity(T, e)
    order, tok, slot, keep = _slots(experts, e, C)
    # the dropped replicas go to a sink row past the buffer
    buf = x.new_zeros((E * C + 1, d))
    buf[torch.where(keep, slot, E * C)] = x[tok]
    buf = buf[:E * C].reshape(ep, e_loc * C, d)
    recv = exchange(buf)                              # (ep, e_loc * C, d)
    ys = recv.reshape(ep, e_loc, C, d).transpose(0, 1).reshape(
        e_loc, ep * C, d)
    h = F.silu(torch.bmm(ys, lp["wg"])) * torch.bmm(ys, lp["wi"])
    out = torch.bmm(h, lp["wo"])
    out = out.reshape(e_loc, ep, C, d).transpose(0, 1).reshape(
        ep, e_loc * C, d)
    back = exchange(out).reshape(E * C, d)
    w = weights.reshape(-1)[order] * keep
    contrib = back[slot.clamp(max=E * C - 1)] * w[:, None].to(back.dtype)
    y = torch.zeros((T, d), dtype=back.dtype, device=x.device).index_add_(
        0, tok, contrib)
    y = _add_shared(lp, x, y, e).to(x.dtype)
    if with_aux:
        return y, load_balance_loss(probs, experts, e)
    return y


def moe_ep(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
           with_aux: bool = False):
    """The ``ep`` layout: x (T, d) -> y (T, d), ``lp`` holding this
    rank's ``E / ep`` experts (and its slice of the shared experts), the
    capacity buffers exchanged over the active mesh's model axis."""
    mesh = SH.model_mesh()
    ep = 1 if mesh is None else mesh.shape["model"]
    return _moe_ep(lp, x, cfg, SH.model_all_to_all, ep, with_aux)


def moe_ep_local(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 with_aux: bool = False):
    """``moe_ep``'s function on one device: whole weights, the same
    capacity and drops, no exchange -- the plain version the exchange
    is held against."""
    return _moe_ep(lp, x, cfg, lambda t: t, 1, with_aux)
