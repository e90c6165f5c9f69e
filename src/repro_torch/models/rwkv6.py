"""RWKV6 ("Finch"): attention-free time mixing with data-dependent
per-channel decay, in chunked-parallel form.

Counterpart of ``repro.models.rwkv6``, the same arithmetic in plain
PyTorch (the reference computes it in jnp, with no Pallas kernel).  Per
head (dk = dv = head_dim), with r/k/v/w from data-dependent token shift
(ddlerp):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Chunked evaluation (chunk C, all log-space, every exponent <= 0):

    c_t      = sum_{i<=t} log w_i        (chunk-local inclusive cumsum)
    o_inter  = (r . exp(c_prev)) @ S_in
    M[t,s]   = sum_d r_td k_sd exp(c_prev[t,d] - c[s,d])   (s < t)
    o_intra  = M @ v + (r . u . k summed) v                 (diagonal)
    S_out    = exp(c_last) . S_in + (k . exp(c_last - c))^T @ v

The intra term is the direct (C, C, dk) contraction, its decay tensor
clipped to [-30, 0] before ``exp`` and rounded to ``ssm.intra_dtype``;
r, k, v and the state are float32.  ``w0`` and ``u`` are float32 in
every config, as in the reference.  The reference's ``lax.scan`` over
chunks is a Python loop here, each chunk's body (its tiles of
``ssm.subchunk`` positions) recomputed in the backward pass
(``common.remat``) as the reference's ``jax.checkpoint(body)`` is.

Over a mesh's model axis (Megatron over the heads) the time mix's
``wr``/``wk``/``wv``/``wg`` are column-parallel and ``wo`` row-parallel;
the token-shift mixes and the decay and mix LoRAs are whole on every
rank, which computes them whole and takes its heads' columns of the
decay (``decay_w2``, ``w0``) and of ``u`` and ``ln_x``.  The wkv
recurrence runs over the rank's heads, and ``ln_x`` (one RMSNorm over
every head, the reference's "group norm") takes its mean of squares
over the whole width (``rmsnorm(width=)``).  The channel mix's ``wk`` is
column-parallel and its ``wv`` row-parallel; ``wr`` stays whole.  Every
width comes from the weights.  Under sequence parallelism both token
shifts see the whole sequence (gathered) and each mix gives back this
rank's sequence piece.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as SH
from repro_torch.models.common import Params, dense_init, remat, rmsnorm


#: logical axes of the time-mix and channel-mix leaves (the reference's
#: ``init_rwkv6_mix`` / ``init_rwkv6_ffn``); the low-rank decay and
#: mixing factors and the per-channel vectors are replicated
MIX_AXES = {"wr": ("embed", "heads"), "wk": ("embed", "heads"),
            "wv": ("embed", "heads"), "wg": ("embed", "heads"),
            "wo": ("heads", "embed")}
FFN_AXES = {"wk": ("embed", "heads"), "wr": ("embed", "embed"),
            "wv": ("heads", "embed")}


def init_rwkv6_mix(generator, cfg: ModelConfig, device) -> Params:
    d, dt = cfg.d_model, cfg.torch_dtype
    s = cfg.ssm
    f32 = dict(dtype=torch.float32, device=device)
    half = dict(dtype=dt, device=device)
    return {
        "mu_x": 0.5 * torch.ones(d, **half),
        "mu": 0.5 * torch.ones((5, d), **half),             # r,k,v,w,g
        "mix_w1": dense_init(generator, d, 5 * s.mix_lora, dt, device,
                             scale=0.01),
        "mix_w2": 0.01 * dense_init(generator, 5 * s.mix_lora, d, dt, device
                                    ).reshape(5, s.mix_lora, d),
        "wr": dense_init(generator, d, d, dt, device),
        "wk": dense_init(generator, d, d, dt, device),
        "wv": dense_init(generator, d, d, dt, device),
        "wg": dense_init(generator, d, d, dt, device),
        "wo": dense_init(generator, d, d, dt, device),
        "w0": -6.0 + 5.0 * torch.rand(d, generator=generator, **f32),
        "decay_w1": dense_init(generator, d, s.decay_lora, dt, device,
                               scale=0.01),
        "decay_w2": 0.01 * dense_init(generator, s.decay_lora, d, dt,
                                      device),
        "u": 0.5 * torch.randn(d, generator=generator, **f32),
        "ln_x": torch.ones(d, **half),                      # group norm
    }


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor):
    """Data-dependent token-shift interpolation -> per-channel mixes."""
    base = x + (xx - x) * p["mu_x"]
    lora = torch.tanh(base @ p["mix_w1"])                    # (B,S,5*lora)
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    off = torch.einsum("bsfl,fld->bsfd", lora, p["mix_w2"])  # (B,S,5,d)
    mix = p["mu"] + off
    vals = x[..., None, :] + (xx - x)[..., None, :] * mix    # (B,S,5,d)
    return tuple(vals[..., i, :] for i in range(5))


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], H, -1)


def _tile(S_in, rb, kb, vb, wb, u, intra_dt):
    """One (B,H,n,dk) tile: direct intra + inter via S_in."""
    n = rb.shape[2]
    c = torch.cumsum(wb, dim=2)                              # inclusive
    cprev = c - wb                                           # exclusive
    o_inter = torch.einsum("bhtd,bhdv->bhtv", rb * torch.exp(cprev), S_in)
    dmat = torch.exp(torch.clamp(cprev[:, :, :, None, :]
                                 - c[:, :, None, :, :], -30.0, 0.0))
    # the decay tensor and both operands rounded to intra_dt, products
    # and sum in float32 (the reference's preferred_element_type)
    r_i, k_i = (t.to(intra_dt).float() for t in (rb, kb))
    M = ((r_i[:, :, :, None, :] * k_i[:, :, None, :, :])
         * dmat.to(intra_dt).float()).sum(-1)                # (B,H,t,s)
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=rb.device),
                      diagonal=-1)
    M = torch.where(mask, M, torch.zeros((), device=rb.device))
    o_intra = torch.einsum("bhts,bhsv->bhtv", M, vb)
    diag = torch.sum(rb * u[None, :, None, :] * kb, dim=-1)  # (B,H,n)
    o = o_inter + o_intra + diag[..., None] * vb
    clast = c[:, :, -1:, :]                                  # (B,H,1,dk)
    S_out = (torch.exp(clast[:, :, 0, :, None]) * S_in
             + torch.einsum("bhtd,bhtv->bhdv", kb * torch.exp(clast - c),
                            vb))
    return S_out, o


def _chunk(S_in, rb, kb, vb, wb, u, sub, intra_dt):
    """One chunk (B,H,C,dk) as tiles of ``sub`` positions in turn."""
    outs = []
    for t0 in range(0, rb.shape[2], sub):
        sl = slice(t0, t0 + sub)
        S_in, o = _tile(S_in, rb[:, :, sl], kb[:, :, sl], vb[:, :, sl],
                        wb[:, :, sl], u, intra_dt)
        outs.append(o)
    return S_in, torch.cat(outs, dim=2)


def _local(p: Params, cfg: ModelConfig):
    """(this rank's heads, the head width, whether the heads are a piece
    of the model's) from the width of its ``wr``."""
    dk = cfg.d_model // cfg.num_heads
    return (p["wr"].shape[-1] // dk, dk,
            SH.is_piece(p["wr"], cfg.d_model))


def _rkvgw(p: Params, x: torch.Tensor, xx: torch.Tensor, Hl: int):
    """This rank's r, k, v (..., Hl, dk) in float32, its g and its log
    decay (..., Hl, dk) from the whole token-shift mixes."""
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    r = _heads(xr @ p["wr"], Hl).float()
    k = _heads(xk @ p["wk"], Hl).float()
    v = _heads(xv @ p["wv"], Hl).float()
    g = F.silu(xg @ p["wg"])
    dl = g.shape[-1]
    lw = (SH.width_piece(p["w0"], dl)
          + (torch.tanh(xw @ p["decay_w1"])
             @ SH.width_piece(p["decay_w2"], dl)).float())
    return r, k, v, g, _heads(-torch.exp(lw), Hl)


def _ln_out(p: Params, o: torch.Tensor, g: torch.Tensor, cfg: ModelConfig,
            split: bool, seq_parallel: bool, dtype) -> torch.Tensor:
    """``ln_x`` over every head, the gate, then ``wo``."""
    o = rmsnorm(o.to(dtype), SH.width_piece(p["ln_x"], o.shape[-1]),
                cfg.norm_eps, width=cfg.d_model) * g
    return SH.whole_seq_row_parallel(o, p["wo"], split, seq_parallel)


def rwkv6_mix_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  prev_x: Optional[torch.Tensor] = None,
                  state_in: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None,
                  seq_parallel: bool = False):
    """Full-sequence chunked time mixing.

    x: (B, S, d).  Returns (y, (last_x, S_out)) so decode can continue;
    state_in: (B, H, dk, dv).  ``lengths`` (B,) masks right padding out
    of the recurrence EXACTLY: padded positions contribute nothing to
    the state (k = 0 kills the rank-1 update, log w = 0 freezes the
    decay at 1), and last_x is each row's last valid token.
    ``seq_parallel``: ``x`` and ``y`` are this model rank's sequence
    piece (B, S / tp, d); ``last_x`` is of the whole sequence.
    """
    if seq_parallel:
        x = SH.seq_gather(x)
    B, S, d = x.shape
    Hl, dk, split = _local(p, cfg)
    C = min(cfg.ssm.chunk, S)
    assert S % C == 0, (S, C)
    first = (prev_x[:, None] if prev_x is not None
             else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    xx = torch.cat([first, x[:, :-1]], dim=1)
    r, k, v, g, logw = _rkvgw(p, x, xx, Hl)                  # (B,S,Hl,dk)
    if lengths is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < lengths.long()[:, None])[:, :, None, None]
        zero = torch.zeros((), device=x.device)
        k = torch.where(valid, k, zero)
        logw = torch.where(valid, logw, zero)
    u = SH.width_piece(p["u"], Hl * dk).reshape(Hl, dk)
    # (B, S, Hl, dk) -> (B, Hl, S, dk): chunks are slices of the S axis
    r, k, v, logw = (t.transpose(1, 2) for t in (r, k, v, logw))
    st = (state_in.float() if state_in is not None
          else torch.zeros((B, Hl, dk, dk), dtype=torch.float32,
                           device=x.device))
    sub = (cfg.ssm.subchunk if cfg.ssm.subchunk and cfg.ssm.subchunk < C
           else C)
    intra_dt = getattr(torch, cfg.ssm.intra_dtype)
    outs = []
    for c0 in range(0, S, C):
        # the reference checkpoints each chunk's body: remat
        sl = slice(c0, c0 + C)
        st, o = remat(_chunk, st, r[:, :, sl], k[:, :, sl], v[:, :, sl],
                      logw[:, :, sl], u, sub, intra_dt)
        outs.append(o)
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, Hl * dk)
    y = _ln_out(p, o, g, cfg, split, seq_parallel, x.dtype)
    if lengths is not None:
        idx = (lengths.long() - 1).clamp(min=0)
        last_x = x[torch.arange(B, device=x.device), idx]
    else:
        last_x = x[:, -1]
    return y, (last_x, st)


def rwkv6_mix_step(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   prev_x: torch.Tensor, state: torch.Tensor):
    """Single-token recurrence.  x, prev_x: (B, d); state: (B,H,dk,dk)."""
    B, d = x.shape
    Hl, dk, split = _local(p, cfg)
    r, k, v, g, logw = (t[:, 0] for t in _rkvgw(p, x[:, None],
                                                 prev_x[:, None], Hl))
    w = torch.exp(logw)                                      # (B,Hl,dk)
    u = SH.width_piece(p["u"], Hl * dk).reshape(Hl, dk)
    kv = k[..., :, None] * v[..., None, :]                   # (B,Hl,dk,dv)
    state = state.float()
    o = torch.einsum("bhd,bhdv->bhv", r, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    return _ln_out(p, o.reshape(B, Hl * dk), g, cfg, split, False,
                   x.dtype), (x, state)


def rwkv6_mix_ref(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Sequential oracle: ``rwkv6_mix_step`` over the tokens from zero
    state."""
    B, S, d = x.shape
    H = cfg.num_heads
    dk = d // H
    px = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    st = torch.zeros((B, H, dk, dk), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y, (px, st) = rwkv6_mix_step(p, x[:, t], cfg, px, st)
        ys.append(y)
    return torch.stack(ys, dim=1)


# -- channel mixing (RWKV ffn) ---------------------------------------------
def init_rwkv6_ffn(generator, cfg: ModelConfig, device) -> Params:
    d, dt = cfg.d_model, cfg.torch_dtype
    return {"mu_k": 0.5 * torch.ones(d, dtype=dt, device=device),
            "mu_r": 0.5 * torch.ones(d, dtype=dt, device=device),
            "wk": dense_init(generator, d, cfg.d_ff, dt, device),
            "wv": dense_init(generator, cfg.d_ff, d, dt, device),
            "wr": dense_init(generator, d, d, dt, device)}


def rwkv6_ffn(p: Params, x: torch.Tensor, xx: torch.Tensor, *,
              split: bool = False, seq_parallel: bool = False
              ) -> torch.Tensor:
    """x: (..., d); xx: token-shifted x of the same shape.  ``split``:
    ``wk`` holds this rank's columns of the hidden dim and ``wv`` its
    rows, summed over the model axis.  ``seq_parallel``: ``x`` (B, S, d)
    is the whole sequence and the result this rank's piece."""
    xk = x + (xx - x) * p["mu_k"]
    xr = x + (xx - x) * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    kv = SH.whole_seq_row_parallel(k, p["wv"], split, seq_parallel)
    if seq_parallel:
        xr = SH.seq_piece(xr, 1)
    return torch.sigmoid(xr @ p["wr"]) * kv
