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

On a ``model`` axis above 1 (the train, forward, serve and prefill
steps) the feed-forward takes one of the reference's layouts
(``cfg.moe.parallel_mode``):

* ``tp`` (``_moe_tp_shardmap``): every rank routes the same tokens with
  the replicated float32 router and runs ``moe_ffn``'s arithmetic on its
  slice of each expert's hidden dim and of the shared experts, with the
  down-projections and the routed combine left in float32; the routed
  and the shared partial outputs are summed over ``model`` in float32
  in one collective and rounded once (``moe_tp``), where one device
  rounds each down-projection, each weighted replica and each add of
  the combine.  A hidden dim the axis does not divide stays whole on
  every rank and is not summed;
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

The router's aux loss stays each data shard's own in both layouts (every
model rank of a shard computes the same one; the train step weights
each rank's by ``1 / (shards * tp)``, the reference's ``pmean`` over the
batch and model axes).  Under sequence parallelism the layer gathers
the shard's whole sequence first and gives back this rank's piece: the
partial sums reduce-scattered, the parts a rank holds whole cut.  In
training every collective takes its adjoint in the backward pass
(``launch/shardings.py``): the all-to-all sends the gradients back, and
the router's gradient is each rank's share, summed over ``model`` with
every replicated leaf's.
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
                     with_aux: bool = False, seq_parallel: bool = False):
    """x3d (B, S, d) -> y (B, S, d), or (y, this shard's aux loss) with
    ``with_aux``.  Under an active mesh the rows are this rank's; on a
    model axis above 1, ``lp`` holds this rank's pieces of the layer's
    weights for ``cfg.moe.parallel_mode``'s layout.  ``seq_parallel``:
    ``x3d`` is this rank's sequence piece (B, S / tp, d); the layer
    routes the whole sequence (gathered), as the reference's shard_map
    takes it, so that the capacity and the aux loss are the data
    shard's, and gives back the piece."""
    B, S, d = x3d.shape
    if SH.model_mesh() is None:
        out = moe_ffn(lp, x3d.reshape(B * S, d), cfg, with_aux=with_aux)
        if with_aux:
            return out[0].reshape(B, S, d), out[1]
        return out.reshape(B, S, d)
    if seq_parallel:
        x3d = SH.seq_gather(x3d)
    x = x3d.reshape(-1, d)
    fn = moe_ep if cfg.moe.parallel_mode == "ep" else moe_tp
    y, aux = fn(lp, x, cfg, rows=x3d.shape[:2] if seq_parallel else None)
    y = y.reshape(B, S, d)
    return (y, aux) if with_aux else y


def _combine(partial, whole, rows, dtype):
    """A layer's output from this rank's float32 partial parts (summed
    over the model axis) and the parts it holds whole, rounded once to
    ``dtype``; with ``rows`` (B, S), this rank's sequence piece only: the
    partial sum reduce-scattered, the whole parts cut."""
    out = None
    if partial:
        total = partial[0] if len(partial) == 1 else partial[0] + partial[1]
        d = total.shape[-1]
        if rows is None:
            out = SH.partial_sum(total)
        else:
            out = SH.partial_sum(total.reshape(*rows, d), True).reshape(-1, d)
    for w in whole:
        if rows is not None:
            w = SH.seq_piece(w.reshape(*rows, w.shape[-1]), 1).reshape(
                -1, w.shape[-1])
        out = w if out is None else out + w
    return out.to(dtype)


def _shared_part(lp: Params, x: torch.Tensor, e, partial, whole) -> None:
    """The shared experts' output of ``x``, into ``partial`` (float32,
    their hidden dim split over the model axis) or ``whole``."""
    if not e.num_shared_experts:
        return
    split = lp["shared_wi"].shape[-1] != e.d_ff_shared
    (partial if split else whole).append(shared_ffn(lp, x, f32=split))


def moe_tp(lp: Params, x: torch.Tensor, cfg: ModelConfig, *, rows=None):
    """The ``tp`` layout on this rank's slices: x (T, d) -> (y, the aux
    loss).  The routed and the shared experts' float32 partial outputs
    are summed over the model axis in one collective where their hidden
    dims are split (a part whose hidden dim stays whole is added after),
    rounded once.  ``rows`` (B, S): ``x`` is the whole sequence and ``y``
    this rank's sequence piece."""
    e = cfg.moe
    weights, experts, probs = route(lp["router"], x, e)
    split = lp["wi"].shape[-1] != e.d_ff_expert
    partial, whole = [], []
    (partial if split else whole).append(
        routed_ffn(lp, x, cfg, weights, experts, f32=split))
    _shared_part(lp, x, e, partial, whole)
    return (_combine(partial, whole, rows, x.dtype),
            load_balance_loss(probs, experts, e))


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
            ep: int, rows=None):
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
    partial, whole = [], [y]
    _shared_part(lp, x, e, partial, whole)
    return (_combine(partial, whole, rows, x.dtype),
            load_balance_loss(probs, experts, e))


def moe_ep(lp: Params, x: torch.Tensor, cfg: ModelConfig, *, rows=None):
    """The ``ep`` layout: x (T, d) -> (y, the aux loss), ``lp`` holding
    this rank's ``E / ep`` experts (and its slice of the shared experts),
    the capacity buffers exchanged over the active mesh's model axis;
    ``rows`` as in ``moe_tp``."""
    mesh = SH.model_mesh()
    ep = 1 if mesh is None else mesh.shape["model"]
    return _moe_ep(lp, x, cfg, SH.model_all_to_all, ep, rows)


def moe_ep_local(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """``moe_ep``'s function on one device: whole weights, the same
    capacity and drops, no exchange -- the plain version the exchange
    is held against (y only)."""
    return _moe_ep(lp, x, cfg, lambda t: t, 1)[0]
