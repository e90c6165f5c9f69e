"""Attention layers over the paged KV pool: GQA/MQA and absorbed MLA.

Counterpart of ``repro.models.attention`` (GQA with the optional
per-head qk-norm of qwen3/gemma3, and MLA on the latent pool, whole or
split into its lora and rope streams):

* ``gqa_fwd_kv``   -- full-prompt attention (prefill), returning K/V,
  causal or (whisper's encoder) not; ``gqa_fwd`` its output alone;
* ``gqa_cross_kv`` / ``gqa_cross`` -- whisper's cross attention: the
  keys and values of the encoder output, and the decoder's queries
  against them, not causal;
* ``gqa_decode``   -- one new token per sequence: ONE call to the fused
  ``paged_attention_append`` kernel appends the token's K/V to the pool
  and attends over the cached tokens plus itself.  It takes the place
  of the reference's ``write_token_paged`` + ``_paged_ref`` +
  ``_merge_self`` (same masks: a window keeps ``pos >= len + 1 - w``,
  and ``window == 0`` means global);
* ``gqa_prefill_paged`` -- suffix-only prefill of a forked child: the
  suffix K/V is scattered into the pool, then ``paged_prefill_attention``
  attends through the block table.

* ``mla_fwd_kv``   -- full-prompt MLA in the decompressed form,
  returning the latent stream ``c_kv || k_rope`` for the pool;
* ``mla_decode``   -- absorbed MLA decode: the new latent row goes into
  the tail block, then ONE ``paged_attention`` call (latent mode, V =
  the first ``kv_lora`` lanes of the same rows) attends over the cached
  tokens, with the new token's float32 score and value merged in as its
  self term.  It takes the place of the reference's ``_paged_ref(lens)``
  + ``_merge_self`` + ``write_token_paged``;
* ``mla_decode_split`` -- the same over the split latent pool (the lora
  stream, or this rank's lanes of it, and the rope stream apart): two
  kernels, ``paged_latent_scores`` (the partial scores, summed over the
  model axis where the lora stream is split) and ``paged_latent_values``
  (the softmax with the self term, applied to the rank's lora lanes).

The pools are one layer's ``(NB, BT, KVH, hd)`` (GQA) or ``(NB, BT,
latent_dim)`` (MLA) views and are updated IN PLACE.

Over a mesh's model axis (Megatron) a rank holds column pieces of the
q/k/v (MLA: ``wq``/``wq_b``, ``wk_b``, ``wv_b``) products and the rows
of ``wo`` that follow them, so every head count comes from the
weights' widths, never from the config: the rank attends over its own
query heads and the KV heads they read (its pools hold just those), and
``wo``'s product is summed over the ranks (``row_parallel``).  MLA's
latent projection is replicated: every rank writes the same latent row
into its own pool.  The split latent pool (``mla_latent_tp``) takes
another layout on the serve and prefill steps: every rank holds every
head, and ``wk_b`` and ``wv_b`` are split on their lora rows, as its
pool's lora stream is on its lanes; the scores and the un-absorbed
output are sums over the ranks' lanes (``mla_decode_split``,
``mla_fwd_kv``).  Where the heads do not divide the axis the weights
replicate, decode runs whole on every rank, and the prompt's attention
is context-parallel: each rank takes its piece of the query rows
against the whole K/V and the pieces are all-gathered.  Under sequence
parallelism (training) the layer takes and gives this rank's sequence
piece: split heads gather the whole sequence before their products and
reduce-scatter after ``wo``; context-parallel attention gathers the K/V
of the pieces instead, and its queries and output stay the piece.

``kernels`` selects the module the attention calls go to:
``ops`` (the default: kernels on CUDA tensors, plain versions on CPU
tensors) or ``ref`` (the plain versions everywhere, the comparison path
that holds the kernels to their plain composition on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import shardings as SH
from repro_torch.models.common import (Params, apply_rope, dense_init,
                                       flash_attention, head_rmsnorm,
                                       rmsnorm)


#: logical axes of the GQA and MLA leaves (``repro.models.attention``'s
#: ``init_gqa`` / ``init_mla``); the qk-norm and latent-norm vectors are
#: replicated
GQA_AXES = {"wq": ("embed", "attn_heads"), "wk": ("embed", "attn_heads"),
            "wv": ("embed", "attn_heads"), "wo": ("attn_heads", "embed")}
MLA_AXES = {"wq": ("embed", "attn_heads"), "wq_a": ("embed", None),
            "wq_b": (None, "attn_heads"), "wkv_a": ("embed", None),
            "wk_b": (None, "attn_heads"), "wv_b": (None, "attn_heads"),
            "wo": ("attn_heads", "embed")}


def init_gqa(generator, cfg: ModelConfig, device) -> Params:
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
    dt = cfg.torch_dtype
    p = {"wq": dense_init(generator, d, H * hd, dt, device),
         "wk": dense_init(generator, d, KVH * hd, dt, device),
         "wv": dense_init(generator, d, KVH * hd, dt, device),
         "wo": dense_init(generator, H * hd, d, dt, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
    return p


def _split(heads: int, cfg: ModelConfig) -> bool:
    """Whether a rank holding ``heads`` query heads holds a piece of
    them, so that ``wo``'s product is summed over the model axis."""
    return heads != cfg.num_heads


def _ctx_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **kw) -> torch.Tensor:
    """Context parallelism: this rank's piece of the query rows (pieces
    of ``ceil(S / tp)`` rows, the last padded) against the whole K/V,
    causal from the piece's offset; the pieces all-gathered."""
    mesh = SH.model_mesh()
    B, S = q.shape[:2]
    n = -(-S // mesh.shape["model"])
    lo = min(mesh.axis_index("model") * n, S)
    piece = q[:, lo:lo + n]
    if piece.shape[1] < n:
        pad = piece.new_zeros((B, n - piece.shape[1]) + tuple(q.shape[2:]))
        piece = torch.cat([piece, pad], dim=1)
    o = flash_attention(piece, k, v, q_offset=lo, **kw)
    return SH.gather_model(o, 1)[:, :S]


def _ctx_attention_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       **kw) -> torch.Tensor:
    """Context parallelism under sequence parallelism: ``q``, ``k`` and
    ``v`` are this rank's sequence piece; the K/V pieces are gathered
    (the backward pass sums dK and dV over the model axis and keeps
    this rank's piece) and the piece's queries attend to the whole K/V
    from the piece's offset.  The output stays the piece."""
    mesh = SH.model_mesh()
    lo = mesh.axis_index("model") * q.shape[1]
    return flash_attention(q, SH.seq_gather(k), SH.seq_gather(v),
                           q_offset=lo, **kw)


def _prompt_attention(q, k, v, cfg: ModelConfig, seq_parallel: bool = False,
                      **kw) -> torch.Tensor:
    """Full-prompt attention, context-parallel where the heads do not
    divide the model axis (``use_ctx_parallel``, reference
    ``attention.py:76-84``); with ``seq_parallel`` the context-parallel
    pieces are the sequence pieces the ranks hold."""
    if SH.use_ctx_parallel(cfg.num_heads) and not _split(q.shape[2], cfg):
        o = (_ctx_attention_seq(q, k, v, **kw) if seq_parallel
             else _ctx_attention(q, k, v, **kw))
    else:
        o = flash_attention(q, k, v, **kw)
    return SH.constrain(o, "batch", None, "attn_heads", None)


def _seq_entry(x: torch.Tensor, positions: torch.Tensor, split: bool,
               seq_parallel: bool):
    """Under sequence parallelism, a projection's input and positions:
    the whole sequence for split heads (gathered), else this rank's
    piece of the positions, beside its piece of ``x``."""
    if not seq_parallel:
        return x, positions
    if split:
        return SH.seq_gather(x), positions
    return x, SH.seq_piece(positions, 1)


def _heads(p: Params, x: torch.Tensor, w: str, norm: str, cfg: ModelConfig,
           positions: torch.Tensor, rope_theta: Optional[float] = None,
           rope: bool = True) -> torch.Tensor:
    """``x @ p[w]`` as (B, S, heads, hd), this rank's heads (the width of
    ``p[w]``), with the qk-norm ``p[norm]`` (per head, after the
    projection) and rope where the config has them."""
    B, S, _ = x.shape
    t = (x @ p[w]).reshape(B, S, p[w].shape[-1] // cfg.hd, cfg.hd)
    if cfg.qk_norm and norm:
        t = head_rmsnorm(t, p[norm], cfg.norm_eps)
    if rope and cfg.rope_theta > 0:
        theta = rope_theta if rope_theta is not None else cfg.rope_theta
        t = apply_rope(t, positions, theta)
    return t


def _gqa_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, rope_theta: Optional[float] = None):
    """q (B, S, H, hd), k and v (B, S, KVH, hd), with this rank's H and
    KVH (the widths of ``wq`` and ``wk``)."""
    return (_heads(p, x, "wq", "q_norm", cfg, positions, rope_theta),
            _heads(p, x, "wk", "k_norm", cfg, positions, rope_theta),
            _heads(p, x, "wv", "", cfg, positions, rope=False))


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None else cfg.hd ** -0.5


def gqa_fwd_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int], positions: torch.Tensor,
               causal: bool = True, rope_theta: Optional[float] = None,
               seq_parallel: bool = False):
    """Full-sequence attention (causal unless ``causal=False``); returns
    (y, (k, v)).  ``seq_parallel``: ``x`` is this rank's sequence piece
    (``positions`` the whole sequence's), and so is ``y``."""
    split = _split(p["wq"].shape[-1] // cfg.hd, cfg)
    x, positions = _seq_entry(x, positions, split, seq_parallel)
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope_theta)
    B, S = x.shape[:2]
    o = _prompt_attention(q, k, v, cfg, seq_parallel and not split,
                          causal=causal, window=window,
                          softcap=cfg.attn_softcap, scale=cfg.query_scale)
    return SH.row_parallel(o.reshape(B, S, -1), p["wo"], split,
                           seq_parallel), (k, v)


def gqa_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            window: Optional[int] = None,
            positions: Optional[torch.Tensor] = None,
            causal: bool = True) -> torch.Tensor:
    """``gqa_fwd_kv``'s output alone; positions default to 0..S-1."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    y, _ = gqa_fwd_kv(p, x, cfg, window=window, positions=positions,
                      causal=causal)
    return y


def gqa_cross_kv(p: Params, enc: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """Cross attention's keys and values over an encoder output ``enc``
    (B, F, d) at ``positions`` (1, F): k and v (B, F, KVH, hd), this
    rank's KV heads (the width of ``wk``): computed from its columns,
    never cut from whole heads."""
    return (_heads(p, enc, "wk", "k_norm", cfg, positions),
            _heads(p, enc, "wv", "", cfg, positions, rope=False))


def gqa_cross(p: Params, x: torch.Tensor, kv, cfg: ModelConfig, *,
              positions: torch.Tensor,
              seq_parallel: bool = False) -> torch.Tensor:
    """Cross attention, not causal: queries from ``x`` (B, S, d) at
    ``positions``, keys and values ``kv`` (``gqa_cross_kv``'s, over
    every frame, this rank's KV heads).  Returns y (B, S, d); split heads
    sum ``wo``'s product over the model axis (``row_parallel``).  With
    ``seq_parallel`` ``x`` is this rank's sequence piece, and so is y:
    split heads gather the whole sequence before ``wq`` and
    reduce-scatter after ``wo``; whole heads (the ``ctx`` rule) take the
    piece's queries against every frame -- the queries and the keys come
    from different streams, so the piece needs no offset."""
    k, v = kv
    split = _split(p["wq"].shape[-1] // cfg.hd, cfg)
    x, positions = _seq_entry(x, positions, split, seq_parallel)
    q = _heads(p, x, "wq", "q_norm", cfg, positions)
    o = flash_attention(q, k, v, causal=False, scale=cfg.query_scale)
    o = SH.constrain(o, "batch", None, "attn_heads", None)
    B, S = x.shape[:2]
    return SH.row_parallel(o.reshape(B, S, -1), p["wo"], split,
                           seq_parallel and split)


def gqa_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
               k_pool: torch.Tensor, v_pool: torch.Tensor,
               block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
               window: int = 0, rope_theta: Optional[float] = None,
               kernels=ops) -> torch.Tensor:
    """One-token decode for one layer.  x: (B, d).  Appends the token's
    K/V at ``seq_lens`` (pre-advance) into the pool in place and returns
    y: (B, d)."""
    B, _ = x.shape
    q, k, v = _gqa_qkv(p, x[:, None], cfg, seq_lens[:, None].long(),
                       rope_theta)
    H, KVH, hd = q.shape[2], k.shape[2], q.shape[3]
    q = SH.constrain(q[:, 0], "batch", "attn_heads", None).reshape(
        B, KVH, H // KVH, hd)
    o, _, _ = kernels.paged_attention_append(
        q, k[:, 0], v[:, 0], k_pool, v_pool, block_tables, seq_lens,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    return SH.row_parallel(o.reshape(B, H * hd).to(x.dtype), p["wo"],
                           _split(H, cfg))


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
    bt = k_pool.shape[1]
    positions = (q_starts.long()[:, None]
                 + torch.arange(SQ, device=x.device)[None, :])
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope_theta)
    H, KVH, hd = q.shape[2], k.shape[2], q.shape[3]
    _scatter_span(k_pool, k, write_tables, bt)
    _scatter_span(v_pool, v, write_tables, bt)
    qh = q.reshape(B, SQ, KVH, H // KVH, hd)
    o = kernels.paged_prefill_attention(
        qh, k_pool, v_pool, block_tables, kv_lens, q_starts,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    return SH.row_parallel(o.reshape(B, SQ, H * hd).to(x.dtype), p["wo"],
                           _split(H, cfg))


# ===================== MLA =====================
def init_mla(generator, cfg: ModelConfig, device) -> Params:
    """MLA parameters; the two low-rank norms start at ONES and are
    applied plainly (``w * x``), not gemma-style (``(1 + w) * x``)."""
    m = cfg.mla
    d, H, dt = cfg.d_model, cfg.num_heads, cfg.torch_dtype
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    p: Params = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(generator, d, m.q_lora_rank, dt, device)
        p["q_a_norm"] = torch.ones(m.q_lora_rank, dtype=dt, device=device)
        p["wq_b"] = dense_init(generator, m.q_lora_rank, H * qk, dt, device)
    else:
        p["wq"] = dense_init(generator, d, H * qk, dt, device)
    p["wkv_a"] = dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dt, device)
    p["kv_a_norm"] = torch.ones(m.kv_lora_rank, dtype=dt, device=device)
    p["wk_b"] = dense_init(generator, m.kv_lora_rank,
                           H * m.qk_nope_head_dim, dt, device)
    p["wv_b"] = dense_init(generator, m.kv_lora_rank, H * m.v_head_dim, dt,
                           device)
    p["wo"] = dense_init(generator, H * m.v_head_dim, d, dt, device)
    return p


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope)),
    H this rank's heads (the width of ``wq`` / ``wq_b``)."""
    m = cfg.mla
    B, S = x.shape[:2]
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.q_lora_rank:
        qa = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
        q = qa @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, q.shape[-1] // qk, qk)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x -> (c_kv normalized (B, S, kv_lora), k_rope (B, S, rope))."""
    m = cfg.mla
    c_kv, k_rope = torch.split(x @ p["wkv_a"],
                               [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_fwd_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, seq_parallel: bool = False):
    """Full-prompt MLA in the decompressed form.  Returns y (B, S, d) and
    the latent stream ``c_kv || k_rope`` (B, S, latent_dim) for the
    paged pool; ``seq_parallel`` as in ``gqa_fwd_kv``."""
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    wq = p["wq_b"] if m.q_lora_rank else p["wq"]
    split = _split(wq.shape[-1] // qk, cfg)
    x, positions = _seq_entry(x, positions, split, seq_parallel)
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    H = q_nope.shape[2]
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    # the split pool's layout: wk_b and wv_b hold this rank's lora rows,
    # so each product is a row-parallel sum over the ranks' lanes
    lora_split = SH.is_piece(p["wk_b"], m.kv_lora_rank, 0)
    c_piece = SH.width_piece(c_kv, p["wk_b"].shape[0])
    k_nope = SH.row_parallel(c_piece, p["wk_b"], lora_split).reshape(
        B, S, H, m.qk_nope_head_dim)
    v = SH.row_parallel(c_piece, p["wv_b"], lora_split).reshape(
        B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = _prompt_attention(q, k, v, cfg, seq_parallel and not split,
                          softcap=cfg.attn_softcap, scale=_mla_scale(cfg))
    y = SH.row_parallel(o.reshape(B, S, -1), p["wo"], split, seq_parallel)
    return y, torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
               c_pool: torch.Tensor, block_tables: torch.Tensor,
               seq_lens: torch.Tensor, *, kernels=ops) -> torch.Tensor:
    """Absorbed-MLA decode for one layer over the latent pool.

    x: (B, d); c_pool: (NB, BT, latent_dim), latent = kv_lora || k_rope,
    updated in place with the new token's row at ``seq_lens``.  Scores
    are ``q_eff . latent`` with ``q_eff = [W_kb^T q_nope, q_rope]``;
    the output ``attn @ c_kv`` is un-absorbed through W_vb, then W_o.

    Precision, as in the reference: ``q_eff`` is computed in float32,
    then ``q_eff * scale`` is rounded to the pool's dtype and handed to
    the kernel with ``scale=1`` -- the operand ``_paged_ref`` scores the
    cached tokens with.  The new token's score ``q_eff * scale . latent``
    stays in float32 and enters the kernel's softmax as its self term,
    with value ``latent[:kv_lora]``, as ``_merge_self`` merges it.  The
    kernel returns the attention output in float32, which is un-absorbed
    through W_vb in float32.  Returns y: (B, d).
    """
    m = cfg.mla
    B = x.shape[0]
    positions = seq_lens[:, None].long()
    q_nope, q_rope = _mla_q(p, x[:, None], cfg, positions)
    H = SH.constrain(q_nope[:, 0], "batch", "attn_heads", None).shape[1]
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wk_b.float())
    q_eff = torch.cat([q_lat, q_rope[:, 0].float()], dim=-1)   # (B, H, LAT)
    c_new, k_rope_new = _mla_latent(p, x[:, None], cfg, positions)
    latent_new = torch.cat([c_new, k_rope_new], dim=-1)[:, 0]  # (B, LAT)
    kref.write_tail_rows(c_pool, latent_new, block_tables, seq_lens)
    pool = c_pool.unsqueeze(2)                  # (NB, BT, KVH=1, LAT)
    q_s = q_eff * _mla_scale(cfg)
    s_self = torch.einsum("bhd,bd->bh", q_s, latent_new.float())[:, None]
    o = kernels.paged_attention(q_s.to(c_pool.dtype)[:, None], pool, pool,
                                block_tables, seq_lens, scale=1.0,
                                v_dim=m.kv_lora_rank, out_dtype=torch.float32,
                                self_score=s_self,
                                self_v=latent_new[:, None, :m.kv_lora_rank])
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o_v = torch.einsum("bhl,lhv->bhv", o[:, 0], wv_b.float())
    return SH.row_parallel(o_v.reshape(B, H * m.v_head_dim).to(x.dtype),
                           p["wo"], _split(H, cfg))


def mla_decode_split(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     c_pool: torch.Tensor, r_pool: torch.Tensor,
                     block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                     kernels=ops) -> torch.Tensor:
    """Absorbed-MLA decode for one layer over the split latent pool (the
    reference's ``mla_decode_split``).

    x: (B, d); c_pool: (NB, BT, Lp), the lora stream -- on a model axis
    that splits it, this rank's ``Lp`` of its ``kv_lora`` lanes, with
    ``wk_b`` and ``wv_b`` holding the same lora rows and every head;
    r_pool: (NB, BT, rope), the shared rope keys, whole.  Both pools take
    the new token's rows at ``seq_lens`` first, in place; the attended
    range stops before them, and the new token enters as the self term.

    Precision, as in the reference: the queries ``q_lat * scale`` and
    ``q_r * scale`` stay float32 (not rounded to the pool's dtype), and
    score the pools' rows taken to float32.  The score is the sum of the
    two contractions, so ``paged_latent_scores`` gives each rank's
    partial scores of its lora lanes (the rope term on the first rank
    only), the self column beside them; they are summed over the model
    axis in float32 (``model_all_reduce``), and ``paged_latent_values``
    masks them at ``seq_lens``, softmaxes them with the self term and
    applies them to the rank's lora lanes.  The output is un-absorbed
    through the rank's rows of ``wv_b`` in float32, summed over the
    ranks (``partial_sum``), rounded once to x's dtype, then ``wo``.
    Without a split the same runs with no collective.  Returns y (B, d).
    """
    m = cfg.mla
    B = x.shape[0]
    positions = seq_lens[:, None].long()
    q_nope, q_rope = _mla_q(p, x[:, None], cfg, positions)
    H = SH.constrain(q_nope[:, 0], "batch", "attn_heads", None).shape[1]
    Lp = c_pool.shape[-1]
    split = Lp != m.kv_lora_rank
    wk_b = p["wk_b"].reshape(Lp, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wk_b.float())
    c_new, rope_new = _mla_latent(p, x[:, None], cfg, positions)
    c_new = SH.width_piece(c_new[:, 0], Lp)          # this rank's lanes
    rope_new = rope_new[:, 0]
    kref.write_tail_rows(c_pool, c_new, block_tables, seq_lens)
    kref.write_tail_rows(r_pool, rope_new, block_tables, seq_lens)
    scale = _mla_scale(cfg)
    # the rope term enters the sum over the ranks once
    rope = not split or SH.model_mesh().axis_index("model") == 0
    s = kernels.paged_latent_scores(
        q_lat * scale, q_rope[:, 0].float() * scale if rope else None,
        c_pool, r_pool, block_tables, seq_lens, c_new,
        rope_new if rope else None)
    if split:
        s = SH.model_all_reduce(s)
    o = kernels.paged_latent_values(s, c_pool, block_tables, seq_lens, c_new)
    wv_b = p["wv_b"].reshape(Lp, H, m.v_head_dim)
    o_v = torch.einsum("bhl,lhv->bhv", o, wv_b.float())
    if split:
        o_v = SH.partial_sum(o_v)
    return SH.row_parallel(o_v.reshape(B, H * m.v_head_dim).to(x.dtype),
                           p["wo"], _split(H, cfg))
