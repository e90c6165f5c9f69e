"""Mixture-of-Experts feed-forward: dropless token choice.

Counterpart of ``repro.models.moe`` (``init_moe``, ``route``,
``moe_ffn``), the same function in plain PyTorch ops -- the reference
computes it in jnp, with no Pallas kernel to port: a float32 router,
softmax, top-k and renormalised weights; SwiGLU over every routed
replica, none dropped; the combine in the activation dtype; shared
experts added after it.

The layout is this package's own.  The reference sorts the replicas by
expert into blocks of up to 256 rows and gathers one expert's weights
per block; at a decode step's few replicas one block holds them all and
the gather copies E + 1 experts' weights per matmul, whatever was
routed.  Here the layout is chosen from the shapes alone (T tokens, k,
E experts), so no op's output shape depends on the routing and a decode
step never waits for the host:

* ``T * k <= E`` (every decode step): each replica gathers its own
  expert's weights -- the bytes follow the replicas, at most E experts;
* ``T * k > E`` (prefill): the reference's expert-sorted block layout,
  with blocks of ``ceil(T k / E)`` rows rounded up to 8 (at most 256),
  so that the gathered weights (``ceil(T k / m) + E`` blocks) and the
  padded rows (``< T k + E m``) both stay within about twice what was
  routed.

Both give each replica's expert output in one canonical order -- token
by token, each token's experts by ascending id -- and the combine adds
a token's k weighted outputs in that order, in the activation dtype:
the order in which the reference's ``.at[token_of].add`` over the
expert-sorted replicas reaches each token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.launch.shardings import matmul_f32
from repro_torch.models.common import Params, dense_init, trunc_normal

#: largest block of the prefill layout (the reference's block)
MAX_BLOCK = 256


def _experts(generator, d_in: int, E: int, d_out: int, dtype,
             device) -> torch.Tensor:
    """(E, d_in, d_out), drawn as the reference draws it: one (d_in,
    E * d_out) matrix of scale ``d_in ** -0.5`` (one float32 temporary
    of that size), split by expert."""
    w = trunc_normal((d_in, E * d_out), d_in ** -0.5, dtype, device,
                     generator)
    return w.reshape(d_in, E, d_out).transpose(0, 1).contiguous()


#: logical axes of the MoE leaves (``repro.models.moe.init_moe``); the
#: router is replicated
MOE_AXES = {"wi": ("expert", "embed", "heads"),
            "wg": ("expert", "embed", "heads"),
            "wo": ("expert", "heads", "embed"),
            "shared_wi": ("embed", "heads"), "shared_wg": ("embed", "heads"),
            "shared_wo": ("heads", "embed")}


def init_moe(generator, cfg: ModelConfig, device) -> Params:
    """The reference's tree: a float32 router (d, E), stacked experts
    ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d), and the shared experts'
    dense SwiGLU where the config has them."""
    e = cfg.moe
    d, dt, E, f = cfg.d_model, cfg.torch_dtype, e.num_experts, e.d_ff_expert
    p: Params = {
        "router": dense_init(generator, d, E, torch.float32, device,
                             scale=0.02),
        "wi": _experts(generator, d, E, f, dt, device),
        "wg": _experts(generator, d, E, f, dt, device),
        "wo": _experts(generator, f, E, d, dt, device)}
    if e.num_shared_experts:
        p["shared_wi"] = dense_init(generator, d, e.d_ff_shared, dt, device)
        p["shared_wg"] = dense_init(generator, d, e.d_ff_shared, dt, device)
        p["shared_wo"] = dense_init(generator, e.d_ff_shared, d, dt, device)
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, e: MoEConfig):
    """x: (T, d) -> (weights (T, k) float32, experts (T, k) int64,
    probs (T, E) float32).  The router runs in float32 whatever x's
    dtype."""
    logits = x.float() @ router_w.float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, e.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    return weights, experts, probs


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      e: MoEConfig) -> torch.Tensor:
    """The reference's ``aux`` from ``route``'s probs and experts:
    Switch-style ``E * sum_e f_e * p_e``.  Serving never computes it;
    the gradient reaches the router through ``p_e`` only."""
    T = probs.shape[0]
    counts = torch.zeros(e.num_experts, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, experts.reshape(-1),
        torch.ones(experts.numel(), dtype=torch.float32,
                   device=probs.device))
    f = counts / max(T * e.top_k, 1)
    return e.num_experts * (f * probs.mean(dim=0)).sum()


def _bmm(a: torch.Tensor, w: torch.Tensor, f32: bool) -> torch.Tensor:
    return matmul_f32(a, w) if f32 else torch.bmm(a, w)


def _swiglu_replicas(p: Params, xr: torch.Tensor, expert: torch.Tensor,
                     f32: bool = False) -> torch.Tensor:
    """xr (R, d), expert (R,) -> (R, d): each replica through its own
    expert, whose weights it gathers; with ``f32`` the down-projection
    is left unrounded in float32."""
    def mm(a, w, f=False):
        return _bmm(a[:, None], w.index_select(0, expert), f)[:, 0]
    h = F.silu(mm(xr, p["wg"])) * mm(xr, p["wi"])
    return mm(h, p["wo"], f32)


def block_rows(R: int, E: int) -> int:
    """Rows per block of the prefill layout for R replicas over E
    experts: the mean replicas per expert, rounded up to 8, at most
    ``MAX_BLOCK``."""
    return min(MAX_BLOCK, 8 * -(-R // (8 * E)))


def _swiglu_blocked(p: Params, xr: torch.Tensor, expert: torch.Tensor,
                    f32: bool = False) -> torch.Tensor:
    """The same function as ``_swiglu_replicas`` on the expert-sorted
    block layout: replicas sorted by expert (stably), each expert's run
    padded to whole blocks of ``block_rows`` rows, one batched matmul
    per weight with one expert per block.  Every shape comes from R, d
    and E alone."""
    R, d = xr.shape
    E = p["wi"].shape[0]
    m = block_rows(R, E)
    nb = -(-R // m) + E
    dev = expert.device
    order = torch.argsort(expert, stable=True)
    sizes = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, expert, torch.ones_like(expert))
    padded = (sizes + m - 1) // m * m
    ends, pends = torch.cumsum(sizes, 0), torch.cumsum(padded, 0)
    starts, pstarts = ends - sizes, pends - padded
    j = torch.arange(R, device=dev)
    e_of = torch.searchsorted(ends, j, right=True).clamp(max=E - 1)
    pos = pstarts[e_of] + (j - starts[e_of])          # sorted j -> its row
    blk = torch.searchsorted(pends, torch.arange(nb, device=dev) * m,
                             right=True).clamp(max=E - 1)
    buf = torch.zeros(nb * m, d, dtype=xr.dtype, device=dev)
    buf[pos] = xr[order]

    def mm(a, w, f=False):
        return _bmm(a, w.index_select(0, blk), f)
    buf = buf.view(nb, m, d)
    h = F.silu(mm(buf, p["wg"])) * mm(buf, p["wi"])
    ys = mm(h, p["wo"], f32).reshape(nb * m, -1)[pos]
    out = torch.empty_like(ys)
    out[order] = ys
    return out


def routed_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
               weights: torch.Tensor, experts: torch.Tensor, *,
               f32: bool = False) -> torch.Tensor:
    """The routed experts' combined output (T, d), in the experts'
    dtype, for ``route``'s ``weights`` and ``experts`` of ``x`` (T, d):
    every replica through its expert (the layout from T, k and E), each
    token's k weighted outputs added by ascending expert id.  With
    ``f32`` (a rank's partial output over a slice of the hidden dim)
    the down-projection and the combine stay in float32, unrounded."""
    e = cfg.moe
    T, d = x.shape
    k = e.top_k
    experts, perm = torch.sort(experts, dim=-1)       # each token ascending
    weights = weights.gather(-1, perm)
    xr = x[:, None].expand(T, k, d).reshape(T * k, d)
    flat = experts.reshape(-1)
    swiglu = (_swiglu_replicas if T * k <= e.num_experts
              else _swiglu_blocked)
    ys = swiglu(p, xr, flat, f32)
    c = (ys * weights.reshape(-1, 1).to(ys.dtype)).reshape(T, k, -1)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    return y


def shared_ffn(p: Params, x: torch.Tensor, *,
               f32: bool = False) -> torch.Tensor:
    """The shared experts' dense SwiGLU of ``x`` (T, d); with ``f32``
    its down-projection is left unrounded in float32."""
    h = F.silu(x @ p["shared_wg"]) * (x @ p["shared_wi"])
    return matmul_f32(h, p["shared_wo"]) if f32 else h @ p["shared_wo"]


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            with_aux: bool = False):
    """Dropless MoE over T tokens.  x: (T, d) -> y (T, d), or with
    ``with_aux`` (the training path) ``(y, aux)``: the reference's
    ``(y, aux)``, ``aux`` being ``load_balance_loss`` of ``route``'s
    output.  ``y`` is the same function either way."""
    e = cfg.moe
    weights, experts, probs = route(p["router"], x, e)
    aux = load_balance_loss(probs, experts, e) if with_aux else None
    y = routed_ffn(p, x, cfg, weights, experts)
    if e.num_shared_experts:
        y = y + shared_ffn(p, x)
    y = y.to(x.dtype)
    return (y, aux) if with_aux else y
