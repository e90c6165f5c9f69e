"""Mamba2 (SSD) block, chunked-parallel, for the pure SSM and the hybrid.

Counterpart of ``repro.models.mamba2``, the same arithmetic in plain
PyTorch (the reference computes it in jnp, with no Pallas kernel).  Per
head (P = head_dim, N = state_dim), scalar decay a_t = exp(dt_t * A_h):

    S_t = a_t S_{t-1} + (dt_t x_t) B_t^T          S: (P, N)
    y_t = S_t C_t + D_h x_t

Chunked form (chunk C) with inclusive log-decay cumsum c_t (all exponents
<= 0 -- stable):

    y_inter[t] = exp(c_t) * (S_in C_t)
    M[t,s]     = exp(c_t - c_s) (C_t . B_s) dt_s     (s <= t)
    y_intra    = M @ x
    S_out      = exp(c_last) S_in
                 + sum_s exp(c_last - c_s) (dt_s x_s) B_s^T

The reference's ``lax.scan`` over chunks is a Python loop over chunks
here, each chunk's body recomputed in the backward pass
(``common.remat``) as the reference's ``jax.checkpoint(body)`` is.
Input path: in_proj -> (z, xBC, dt); causal conv1d (width 4) +
silu on xBC, in float32; gated RMSNorm before out_proj.  ``conv_w``,
``conv_b``, ``A_log``, ``dt_bias`` and ``D`` are float32 in every
config, as in the reference.

Over a mesh's model axis (Megatron over the SSD heads) a rank holds its
heads' columns of ``z``, ``x`` and ``dt`` in ``in_proj`` with ``B`` and
``C`` whole (``shardings.Packed``), its channels of the conv (its heads'
``x`` channels, ``B`` and ``C``), its heads' piece of ``norm`` and rows
of ``out_proj``; ``A_log``, ``dt_bias`` and ``D`` are whole and each
rank takes its heads' entries.  Every width comes from the weights: a
rank runs the conv, the SSD scan and the one-token step over its H / tp
heads, the gated norm takes its mean of squares over the whole inner
width (``rmsnorm(width=)``), and ``out_proj``'s product is summed over
the ranks (``shardings.row_parallel``).  Under sequence parallelism the
mixer takes this rank's sequence piece, gathers the whole sequence (the
conv must see each token's predecessors, the scan every earlier token)
and gives back the piece.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as SH
from repro_torch.models.common import Params, dense_init, remat, rmsnorm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim, s.conv_width


#: logical axes of the mixer's leaves (``repro.models.mamba2``'s init);
#: A_log, D and dt_bias are replicated
MAMBA2_AXES = {"in_proj": ("embed", "heads"), "out_proj": ("heads", "embed"),
               "conv_w": (None, "heads"), "conv_b": ("heads",),
               "norm": ("heads",)}


def init_mamba2(generator, cfg: ModelConfig, device) -> Params:
    """The reference's tree; the numbers come from ``generator`` (which
    must live on ``device``)."""
    d, dt = cfg.d_model, cfg.torch_dtype
    d_inner, H, P, N, W = _dims(cfg)
    conv_dim = d_inner + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    # dt_bias = softplus^-1(dt0) with dt0 log-uniform in [1e-3, 1e-1]
    u = torch.rand(H, generator=generator, **f32)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt0 = torch.exp(lo.to(device) + u * (hi - lo).to(device))
    return {
        "in_proj": dense_init(generator, d, 2 * d_inner + 2 * N + H, dt,
                              device),
        "conv_w": 0.1 * torch.randn((W, conv_dim), generator=generator,
                                    **f32),
        "conv_b": torch.zeros(conv_dim, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "D": torch.ones(H, **f32),
        "norm": torch.ones(d_inner, dtype=dt, device=device),
        "out_proj": dense_init(generator, d_inner, d, dt, device),
    }


def _local(p: Params, cfg: ModelConfig):
    """(this rank's inner width, its heads, whether they are a piece of
    the model's) from the widths of its weights."""
    d_inner, H, P, N, W = _dims(cfg)
    dl = p["norm"].shape[-1]
    return dl, dl // P, SH.is_piece(p["norm"], d_inner)


def _split_proj(p: Params, x: torch.Tensor, cfg: ModelConfig):
    d_inner, H, P, N, W = _dims(cfg)
    dl, Hl, _ = _local(p, cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :dl]
    xBC = zxbcdt[..., dl: 2 * dl + 2 * N]
    dt = F.softplus(zxbcdt[..., -Hl:].float()
                    + SH.width_piece(p["dt_bias"], Hl))
    return z, xBC, dt


def _conv(p: Params, xBC: torch.Tensor, conv_state: torch.Tensor,
          lengths: Optional[torch.Tensor] = None):
    """Causal conv1d over (B, S, conv_dim) given (B, W-1, conv_dim) state.

    With ``lengths``, the returned state is the window ending at each
    row's LAST VALID token (padded tail excluded); ``lengths[b] == S``
    reduces exactly to the unmasked tail window.
    """
    W = p["conv_w"].shape[0]
    full = torch.cat([conv_state, xBC.float()], dim=1)
    T = full.shape[1]
    out = sum(full[:, i: T - (W - 1 - i)] * p["conv_w"][i] for i in range(W))
    if lengths is None:
        state = full[:, -(W - 1):]
    else:
        idx = (lengths.long()[:, None]
               + torch.arange(W - 1, device=full.device)[None, :])
        state = torch.gather(
            full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))
    return F.silu(out + p["conv_b"]), state


def _ssd_chunk(st, xb, Bb, Cb, dtb, ldb):
    """One chunk of the SSD scan from state ``st`` (B,H,P,N): xb
    (B,C,H,P), Bb/Cb (B,C,N), dtb/ldb (B,C,H) -> (state after the chunk,
    y (B,C,H,P))."""
    C = xb.shape[1]
    c = torch.cumsum(ldb, dim=1)                             # (B,C,H)
    y_inter = torch.exp(c)[..., None] * torch.einsum(
        "bhpn,btn->bthp", st, Cb)
    cb = Cb @ Bb.transpose(1, 2)                             # (B,t,s)
    decay = torch.exp(torch.clamp(c[:, :, None, :] - c[:, None, :, :],
                                  -60.0, 0.0))               # (B,t,s,H)
    M = cb[..., None] * decay * dtb[:, None, :, :]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=xb.device))[None, :, :, None]
    M = torch.where(mask, M, torch.zeros((), device=xb.device))
    y_intra = torch.einsum("btsh,bshp->bthp", M, xb)
    clast = c[:, -1:, :]                                     # (B,1,H)
    w = torch.exp(clast - c) * dtb                           # (B,C,H)
    st = (torch.exp(clast)[:, 0, :, None, None] * st
          + torch.einsum("bthp,btn->bhpn", w[..., None] * xb, Bb))
    return st, y_inter + y_intra


def _gated_norm_out(p: Params, y: torch.Tensor, z: torch.Tensor,
                    cfg: ModelConfig, split: bool, seq_parallel: bool):
    """The gated RMSNorm over the whole inner width, then ``out_proj``
    (row-parallel where the heads are split)."""
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps, width=_dims(cfg)[0])
    return SH.whole_seq_row_parallel(y, p["out_proj"], split, seq_parallel)


def mamba2_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig,
               conv_state: Optional[torch.Tensor] = None,
               ssd_state: Optional[torch.Tensor] = None,
               lengths: Optional[torch.Tensor] = None,
               seq_parallel: bool = False):
    """x: (B, S, d) -> (y, (conv_state, ssd_state)).

    ``lengths`` (B,) masks a right-padded batch EXACTLY: padded
    positions get dt = 0, so their decay is exp(0) = 1 and their state
    contribution 0 -- each row's state passes its tail unchanged, and
    the conv state is read at the last valid token.  Outputs at padded
    positions are garbage; callers index by length.  ``seq_parallel``:
    ``x`` and ``y`` are this model rank's sequence piece (B, S / tp, d).
    """
    if seq_parallel:
        x = SH.seq_gather(x)
    B, S, d = x.shape
    d_inner, H, P, N, W = _dims(cfg)
    dl, Hl, split = _local(p, cfg)
    C = min(cfg.ssm.chunk, S)
    assert S % C == 0, (S, C)
    z, xBC, dt = _split_proj(p, x, cfg)
    if lengths is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < lengths.long()[:, None])
        dt = dt * valid[..., None]
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, dl + 2 * N),
                                 dtype=torch.float32, device=x.device)
    xBC, conv_out_state = _conv(p, xBC, conv_state, lengths=lengths)
    xs = xBC[..., :dl].reshape(B, S, Hl, P)
    Bm = xBC[..., dl: dl + N]                                # (B,S,N)
    Cm = xBC[..., dl + N:]                                   # (B,S,N)
    A = -torch.exp(SH.width_piece(p["A_log"], Hl))           # (Hl,) < 0
    logdecay = dt * A                                        # (B,S,Hl) <= 0
    st = (ssd_state.float() if ssd_state is not None
          else torch.zeros((B, Hl, P, N), dtype=torch.float32,
                           device=x.device))
    ys = []
    for c0 in range(0, S, C):
        # the reference checkpoints this body: remat
        st, yc = remat(_ssd_chunk, st, xs[:, c0:c0 + C], Bm[:, c0:c0 + C],
                       Cm[:, c0:c0 + C], dt[:, c0:c0 + C],
                       logdecay[:, c0:c0 + C])
        ys.append(yc)
    y = torch.cat(ys, dim=1)
    y = y + SH.width_piece(p["D"], Hl)[None, None, :, None] * xs
    y = y.reshape(B, S, dl).to(x.dtype)
    return (_gated_norm_out(p, y, z, cfg, split, seq_parallel),
            (conv_out_state, st))


def mamba2_step(p: Params, x: torch.Tensor, cfg: ModelConfig,
                conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """Single-token recurrence.  x: (B, d)."""
    B, d = x.shape
    d_inner, H, P, N, W = _dims(cfg)
    dl, Hl, split = _local(p, cfg)
    z, xBC, dt = _split_proj(p, x[:, None], cfg)
    xBC, conv_state = _conv(p, xBC, conv_state)
    xs = xBC[:, 0, :dl].reshape(B, Hl, P)
    Bm = xBC[:, 0, dl: dl + N]
    Cm = xBC[:, 0, dl + N:]
    A = -torch.exp(SH.width_piece(p["A_log"], Hl))
    a = torch.exp(dt[:, 0] * A)                              # (B,Hl)
    upd = (dt[:, 0, :, None, None] * xs[..., None]) * Bm[:, None, None, :]
    S_new = a[:, :, None, None] * ssd_state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", S_new, Cm)
    y = y + SH.width_piece(p["D"], Hl)[None, :, None] * xs
    y = y.reshape(B, dl).to(x.dtype)
    return _gated_norm_out(p, y, z[:, 0], cfg, split, False), (conv_state,
                                                                S_new)


def mamba2_ref(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential oracle: ``mamba2_step`` over the tokens from zero state."""
    B, S, d = x.shape
    d_inner, H, P, N, W = _dims(cfg)
    cs = torch.zeros((B, W - 1, d_inner + 2 * N), dtype=torch.float32,
                     device=x.device)
    ss = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y, (cs, ss) = mamba2_step(p, x[:, t], cfg, cs, ss)
        ys.append(y)
    return torch.stack(ys, dim=1)
