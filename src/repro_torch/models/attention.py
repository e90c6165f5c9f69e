"""GQA/MQA attention layers over the paged KV pool.

Counterpart of the GQA half of ``repro.models.attention``:

* ``gqa_fwd_kv``   -- full-prompt attention (prefill), returning K/V;
* ``gqa_decode``   -- one new token per sequence: ONE call to the fused
  ``paged_attention_append`` kernel appends the token's K/V to the pool
  and attends over the cached tokens plus itself.  It takes the place
  of the reference's ``write_token_paged`` + ``_paged_ref`` +
  ``_merge_self`` (same masks: a window keeps ``pos >= len + 1 - w``,
  and ``window == 0`` means global);
* ``gqa_prefill_paged`` -- suffix-only prefill of a forked child: the
  suffix K/V is scattered into the pool, then ``paged_prefill_attention``
  attends through the block table.

The pools are one layer's ``(NB, BT, KVH, hd)`` views and are updated IN
PLACE.  ``kernels`` selects the module the attention calls go to:
``ops`` (the default: kernels on CUDA tensors, plain versions on CPU
tensors) or ``ref`` (the plain versions everywhere, the comparison path
that holds the kernels to their plain composition on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (Params, apply_rope, dense_init,
                                       flash_attention)


def init_gqa(generator, cfg: ModelConfig, device) -> Params:
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
    dt = cfg.torch_dtype
    if cfg.qk_norm:
        raise NotImplementedError("qk-norm attention is not ported yet")
    return {"wq": dense_init(generator, d, H * hd, dt, device),
            "wk": dense_init(generator, d, KVH * hd, dt, device),
            "wv": dense_init(generator, d, KVH * hd, dt, device),
            "wo": dense_init(generator, H * hd, d, dt, device)}


def _gqa_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, rope_theta: Optional[float] = None):
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KVH, hd)
    v = (x @ p["wv"]).reshape(B, S, KVH, hd)
    if cfg.rope_theta > 0:
        theta = rope_theta if rope_theta is not None else cfg.rope_theta
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None else cfg.hd ** -0.5


def gqa_fwd_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int], positions: torch.Tensor,
               rope_theta: Optional[float] = None):
    """Full-sequence causal attention; returns (y, (k, v))."""
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope_theta)
    B, S = x.shape[:2]
    o = flash_attention(q, k, v, window=window,
                        softcap=cfg.attn_softcap, scale=cfg.query_scale)
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def gqa_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
               k_pool: torch.Tensor, v_pool: torch.Tensor,
               block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
               window: int = 0, rope_theta: Optional[float] = None,
               kernels=ops) -> torch.Tensor:
    """One-token decode for one layer.  x: (B, d).  Appends the token's
    K/V at ``seq_lens`` (pre-advance) into the pool in place and returns
    y: (B, d)."""
    B, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q, k, v = _gqa_qkv(p, x[:, None], cfg, seq_lens[:, None].long(),
                       rope_theta)
    q = q[:, 0].reshape(B, KVH, H // KVH, hd)
    o, _, _ = kernels.paged_attention_append(
        q, k[:, 0], v[:, 0], k_pool, v_pool, block_tables, seq_lens,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    return o.reshape(B, H * hd).to(x.dtype) @ p["wo"]


def _scatter_span(pool_l: torch.Tensor, kv: torch.Tensor,
                  write_tables: torch.Tensor, bt: int) -> None:
    """Scatter a block-aligned token span into one layer's pool, in
    place.  kv: (B, SQ, KVH, hd), SQ % bt == 0; write_tables: (B, SQ //
    bt) block ids (the sink where a block is aliased or padding: those
    writes land in the sink and are never read back)."""
    B, SQ = kv.shape[:2]
    nb = SQ // bt
    val = kv.to(pool_l.dtype).reshape(B * nb, bt, *kv.shape[2:])
    pool_l[write_tables.reshape(B * nb).long()] = val


def gqa_prefill_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables: torch.Tensor, kv_lens: torch.Tensor,
                      q_starts: torch.Tensor, write_tables: torch.Tensor, *,
                      window: int = 0, rope_theta: Optional[float] = None,
                      kernels=ops) -> torch.Tensor:
    """Suffix-only prefill for one layer (COW prefix sharing).

    x: (B, SQ, d) hiddens of the un-cached suffix; row b's token i sits
    at absolute position q_starts[b] + i.  The suffix K/V goes into the
    pool first (through ``write_tables``), then every suffix query
    attends through the block table to prefix + suffix.  Returns
    y: (B, SQ, d); the pools are updated in place.
    """
    B, SQ, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    bt = k_pool.shape[1]
    positions = (q_starts.long()[:, None]
                 + torch.arange(SQ, device=x.device)[None, :])
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope_theta)
    _scatter_span(k_pool, k, write_tables, bt)
    _scatter_span(v_pool, v, write_tables, bt)
    qh = q.reshape(B, SQ, KVH, H // KVH, hd)
    o = kernels.paged_prefill_attention(
        qh, k_pool, v_pool, block_tables, kv_lens, q_starts,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    return o.reshape(B, SQ, H * hd).to(x.dtype) @ p["wo"]
