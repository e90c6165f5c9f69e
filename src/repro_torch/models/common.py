"""Shared building blocks: init helpers, norms, RoPE, MLPs, attention.

Parameters are plain nested dicts of tensors with the same tree and
layouts as the reference package's (per-layer weights stacked on a
leading L axis), so ``models/convert.py`` maps one onto the other leaf
by leaf.  Arithmetic follows ``repro.models.common``: norms and RoPE in
float32, GeGLU with the tanh-approximated GELU that ``jax.nn.gelu``
uses by default, and attention logits in float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_NEG = -1e30


# -- init --------------------------------------------------------------------
def trunc_normal(shape, scale: float, dtype: torch.dtype, device,
                 generator: torch.Generator) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], drawn in
    float32 from ``generator`` (which must live on ``device``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (t * scale).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype, device, *,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return trunc_normal((d_in, d_out), scale, dtype, device, generator)


# -- norms ---------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
            gemma_style: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    out = x * (1.0 + w) if gemma_style else x * w
    return out.to(dt)


def head_rmsnorm(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (qwen3/gemma3): x (..., H, hd), weight (hd,).
    Plain ``x * w`` in float32 (not gemma-style), cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


# -- rotary embeddings ------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLP -----------------------------------------------------------------------
def mlp(x: torch.Tensor, p: Params, kind: str = "swiglu") -> torch.Tensor:
    g = x @ p["wg"]
    act = F.gelu(g, approximate="tanh") if kind == "geglu" else F.silu(g)
    return (act * (x @ p["wi"])) @ p["wo"]


# -- full-prompt attention -----------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact causal attention over a whole prompt (prefill).

    q: (B, Sq, H, Dk); k: (B, Sk, KVH, Dk); v: (B, Sk, KVH, Dv).  GQA by
    grouping q as (B, Sq, KVH, G, Dk).  The reference computes this in
    jnp (no Pallas kernel), so this plain version is its counterpart:
    operands rounded to the model dtype, logits and softmax in float32.
    ``window`` of None or <= 0 means global.
    """
    B, Sq, H, Dk = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    if scale is None:
        scale = Dk ** -0.5
    qg = (q * scale).to(k.dtype).reshape(B, Sq, KVH, G, Dk)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    if window is not None and window > 0:
        valid &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, -1).to(q.dtype)
