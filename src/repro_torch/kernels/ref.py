"""Plain PyTorch versions of the block, paged-attention, split-latent,
tree and AdamW kernels.

Each function computes exactly what its CUDA kernel in ``csrc/``
computes, in straightforward tensor code that runs on any device.  The
CPU tests hold these against the JAX package's Pallas kernels (run in
interpret mode) and its jnp oracles; ``chip_smoke.py`` holds each CUDA
kernel against its plain version on the card.  ``kernels/ops.py`` uses
them only for tensors that lie on the CPU.

Conventions shared with the kernels (and the reference):

* NULL (-1) table entries are clamped to block 0 and masked by length.
  Torch indexing wraps negative indices, so the clamp is explicit.
* Pools are updated IN PLACE (the Pallas kernels alias them through
  ``input_output_aliases``).
* ``window`` of None or 0 means global attention; a positive window
  keeps key positions ``>= q_pos - window + 1`` -- except in
  ``paged_attention_ref``, which keeps the Pallas ``paged_attention``
  convention ``pos >= lens - window`` (one position wider).  Pallas
  with ``window=0`` masks every key; here 0 means global.
* A row with no key to attend (length 0, and no self term) gives 0, as
  the reference's model path (``_paged_ref``) does; the Pallas kernels
  give the mean of the table's V rows there instead.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def _window_on(window: Optional[int]) -> bool:
    return window is not None and window > 0


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            softcap: Optional[float], eq: str) -> torch.Tensor:
    s = torch.einsum(eq, q.float() * scale, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def write_tail_rows(pool, rows, block_tables, seq_lens) -> None:
    """Write each sequence's new row into the tail block
    ``tables[b, min(lens // BT, MB - 1)]`` at offset ``lens - jt * BT``,
    in place: the append kernel's masked write.  NULL entries clamp to
    block 0, and a full table drops the write (the row rewrites the value
    already there, so no host sync picks the rows).

    pool: (NB, BT, *row); rows: (B, *row); block_tables: (B, MB) int32;
    seq_lens: (B,) int32 (before the append).
    """
    BT = pool.shape[1]
    MB = block_tables.shape[1]
    lens = seq_lens.long()
    jt = torch.clamp(lens // BT, max=MB - 1)
    b = torch.arange(lens.shape[0], device=lens.device)
    phys = block_tables.long()[b, jt].clamp(min=0)
    off = lens - jt * BT
    keep = (off < BT).reshape(-1, *[1] * (rows.dim() - 1))
    off = off.clamp(max=BT - 1)
    pool[phys, off] = torch.where(keep, rows.to(pool.dtype), pool[phys, off])


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                        scale: Optional[float] = None,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None,
                        v_dim: Optional[int] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        self_score: Optional[torch.Tensor] = None,
                        self_v: Optional[torch.Tensor] = None):
    """Flash-decode attention of one query token over ``seq_lens``
    cached tokens (no append).

    q: (B, KVH, G, HD); k_pool: (NB, BT, KVH, HD); v_pool: (NB, BT, KVH,
    VS) with V its first ``v_dim`` lanes (default all) -- MLA latent mode
    passes the K pool itself as ``v_pool`` with ``v_dim = kv_lora``;
    block_tables: (B, MB) int32; seq_lens: (B,) int32.  Scores in
    float32 from ``q * scale``; a positive window keeps ``pos >= lens -
    window``.  The optional self term, ``self_score`` (B, KVH, G) and
    ``self_v`` (B, KVH, VD) given together, is one more key whose score
    (taken as given: no scale, softcap or mask) and value enter the same
    softmax in float32 -- the reference's ``_paged_ref`` followed by
    ``_merge_self``.  Returns o: (B, KVH, G, VD) in ``out_dtype``
    (default q's dtype).
    """
    B, KVH, G, HD = q.shape
    BT = k_pool.shape[1]
    MB = block_tables.shape[1]
    VD = v_dim if v_dim is not None else v_pool.shape[-1]
    if scale is None:
        scale = HD ** -0.5
    tbl = block_tables.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, MB * BT, KVH, HD)
    v = v_pool[tbl].reshape(B, MB * BT, KVH, -1)[..., :VD]
    s = _scores(q, k, scale, softcap, "bhgd,bshd->bhgs")
    pos = torch.arange(MB * BT, device=q.device)[None, :]
    n = seq_lens.long()[:, None]
    valid = pos < n
    if _window_on(window):
        valid &= pos >= n - window
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    if self_score is not None:
        s_self = self_score.float()[..., None]  # (B, KVH, G, 1)
        m = torch.maximum(m, s_self)
    p = torch.exp(s - m) * vmask                 # masked rows -> 0
    l = p.sum(dim=-1, keepdim=True)
    if self_score is not None:
        p_self = torch.exp(s_self - m)
        l = l + p_self
    l = l.clamp(min=1e-30)
    o = torch.einsum("bhgs,bshd->bhgd", p / l, v.float())
    if self_score is not None:
        o = o + p_self / l * self_v.float()[:, :, None, :]
    return o.to(q.dtype if out_dtype is None else out_dtype)


def paged_attention_append_ref(q, k_new, v_new, k_pool, v_pool,
                               block_tables, seq_lens, *,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None):
    """Append-then-attend decode step for one layer: ``write_tail_rows``
    of the new token's K/V, then ``paged_attention_ref`` over ``lens +
    1`` positions (so a window keeps ``pos >= lens + 1 - window``).
    Returns ``(o, k_pool, v_pool)`` with the pools updated in place.

    q: (B, KVH, G, HD); k_new: (B, KVH, HD); v_new: (B, KVH, VD);
    k_pool: (NB, BT, KVH, HD); v_pool: (NB, BT, KVH, VD);
    block_tables: (B, MB) int32; seq_lens: (B,) int32 (before the append).
    Returns o: (B, KVH, G, VD) in q's dtype.
    """
    write_tail_rows(k_pool, k_new, block_tables, seq_lens)
    write_tail_rows(v_pool, v_new, block_tables, seq_lens)
    o = paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens + 1,
                            scale=scale, softcap=softcap, window=window)
    return o, k_pool, v_pool


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, kv_lens,
                                q_starts, *, scale: Optional[float] = None,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None):
    """Suffix prefill attention through the block table.

    Query i of row b sits at absolute position ``q_starts[b] + i`` and
    attends causally to key positions ``<= q`` and ``< kv_lens[b]``; a
    window keeps ``kv >= q - window + 1``.  Fully-masked rows give 0.

    q: (B, SQ, KVH, G, HD); pools (NB, BT, KVH, HD/VD); tables (B, MB);
    kv_lens, q_starts: (B,) int32.  Returns (B, SQ, KVH, G, VD).
    """
    B, SQ, KVH, G, HD = q.shape
    BT = k_pool.shape[1]
    MB = block_tables.shape[1]
    if scale is None:
        scale = HD ** -0.5
    tbl = block_tables.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, MB * BT, KVH, HD)
    v = v_pool[tbl].reshape(B, MB * BT, KVH, -1)
    s = _scores(q, k, scale, softcap, "bqhgd,bshd->bhgqs")
    kv_pos = torch.arange(MB * BT, device=q.device)[None, None, :]
    q_abs = (q_starts.long()[:, None]
             + torch.arange(SQ, device=q.device)[None, :])[:, :, None]
    valid = (kv_pos <= q_abs) & (kv_pos < kv_lens.long()[:, None, None])
    if _window_on(window):
        valid &= kv_pos > q_abs - window
    vmask = valid[:, None, None, :, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * vmask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqs,bshd->bqhgd", p / l.clamp(min=1e-30), v.float())
    return o.to(q.dtype)


def paged_latent_scores_ref(q_lat, q_r, c_pool, r_pool, block_tables,
                            seq_lens, c_self, r_self):
    """Pass 1 of split-latent MLA decode: the partial scores of one query
    token against ``seq_lens`` cached tokens of the lora stream (this
    rank's ``Lp`` lanes of it) plus, where ``q_r`` is given, the rope
    stream -- the reference's ``q_lat * scale . k_lora + q_r * scale .
    k_rope`` (``repro/models/attention.py:495-499``, the two sums in
    that order), the queries scaled by the caller.

    q_lat: (B, H, Lp) float32; q_r: (B, H, R) float32 or None; c_pool:
    (NB, BT, Lp); r_pool: (NB, BT, R) (read only with ``q_r``);
    block_tables: (B, MB) int32 (NULL clamps to block 0); seq_lens: (B,)
    int32; c_self (B, Lp) and r_self (B, R) (with ``q_r``): the new
    token's rows, which the pools' attended range leaves out.

    Returns (B, H, MB * BT + 1) float32: column ``t < MB * BT`` the score
    of position t where ``t < seq_lens``, else 0 (the mask is applied
    after the ranks' sum, by ``paged_latent_values_ref``: a ``_NEG``
    added here would be counted once per rank); the last column the new
    token's own score.
    """
    B, H, Lp = q_lat.shape
    BT = c_pool.shape[1]
    MB = block_tables.shape[1]
    tbl = block_tables.long().clamp(min=0)
    k = c_pool[tbl].reshape(B, MB * BT, Lp).float()
    s = torch.einsum("bhl,bsl->bhs", q_lat, k)
    s_self = torch.einsum("bhl,bl->bh", q_lat, c_self.float())
    if q_r is not None:
        r = r_pool[tbl].reshape(B, MB * BT, -1).float()
        s = s + torch.einsum("bhr,bsr->bhs", q_r, r)
        s_self = s_self + torch.einsum("bhr,br->bh", q_r, r_self.float())
    pos = torch.arange(MB * BT, device=q_lat.device)[None, :]
    valid = (pos < seq_lens.long()[:, None])[:, None, :]
    s = torch.where(valid, s, torch.zeros((), device=s.device))
    return torch.cat([s, s_self[..., None]], dim=-1)


def paged_latent_values_ref(s, c_pool, block_tables, seq_lens, c_self):
    """Pass 2 of split-latent MLA decode: the summed scores ``s`` (B, H,
    MB * BT + 1), as pass 1 gives them and the model axis sums them,
    masked at positions ``>= seq_lens``, softmaxed with the new token's
    score (the last column) as the self term, and applied to this rank's
    lanes of the lora stream plus ``c_self`` (B, Lp) -- the reference's
    lines (``repro/models/attention.py:500-513``, ``_merge_self``).
    Returns (B, H, Lp) float32; a row with no cached key gives
    ``c_self``."""
    B = s.shape[0]
    BT = c_pool.shape[1]
    MB = block_tables.shape[1]
    N, Lp = MB * BT, c_pool.shape[-1]
    tbl = block_tables.long().clamp(min=0)
    k = c_pool[tbl].reshape(B, N, Lp).float()
    pos = torch.arange(N, device=s.device)[None, :]
    valid = (pos < seq_lens.long()[:, None])[:, None, :]
    sc = torch.where(valid, s[..., :N], torch.full((), _NEG, device=s.device))
    s_self = s[..., N]
    mx = sc.amax(dim=-1)
    pr = torch.exp(sc - mx[..., None]) * valid
    l = pr.sum(dim=-1)
    o = torch.einsum("bhs,bsl->bhl", pr, k) / l.clamp(min=1e-30)[..., None]
    m_new = torch.maximum(mx, s_self)
    a_c = torch.exp(mx - m_new) * l
    a_s = torch.exp(s_self - m_new)
    denom = (a_c + a_s).clamp(min=1e-30)
    return (o * a_c[..., None] + c_self.float()[:, None, :]
            * a_s[..., None]) / denom[..., None]


def copy_pool_blocks_ref(pool, src, dst):
    """``pool[:, dst[i]] = pool[:, src[i]]`` on every layer, in place
    (the right-hand side is gathered first: a snapshot)."""
    pool[:, dst.long()] = pool[:, src.long()]
    return pool


def block_copy_ref(pool, src, dst):
    """Unlayered ``(NB, *blk)`` form of ``copy_pool_blocks_ref``."""
    pool[dst.long()] = pool[src.long()]
    return pool


def gather_blocks_ref(pool, idx):
    """Compact ``(L, n, *blk)`` payload of blocks ``idx``."""
    return pool[:, idx.long()]


def scatter_blocks_ref(pool, idx, payload):
    """``pool[:, idx] = payload`` in place; ``idx`` entries distinct."""
    pool[:, idx.long()] = payload.to(pool.dtype)
    return pool


def tree_gather_ref(leaves, leaf_table):
    """``leaves[leaf_table]``: a TreeArray's leaves in logical order,
    (n, leaf) from an (NB, leaf) pool and an (n,) table."""
    return leaves[leaf_table.long()]


def tree_block_sum_ref(leaves, leaf_table):
    """The float32 sum of each logical leaf: (n,) float32."""
    return leaves[leaf_table.long()].float().sum(dim=1)


def tree_gather_rows_ref(pool, row_ids, leaf_table, rows_per_block: int):
    """Rows of a blocked 2-D array through the leaf table (a paged
    embedding lookup): row ``r`` is row ``r % rows_per_block`` of block
    ``leaf_table[r // rows_per_block]`` of the (NB, RPB, W) pool."""
    rows = row_ids.long()
    phys = leaf_table.long()[rows // rows_per_block]
    return pool[phys, rows % rows_per_block]


#: the attention wrappers' names in ``ops``, so a model can take this
#: module in place of ``ops`` and run the plain versions on any device
paged_attention = paged_attention_ref
paged_attention_append = paged_attention_append_ref
paged_prefill_attention = paged_prefill_attention_ref
paged_latent_scores = paged_latent_scores_ref
paged_latent_values = paged_latent_values_ref


def adamw_update_ref(p, g, m, v, scale, lr, b1c, b2c, cfg) -> None:
    """One AdamW update of one leaf, in place (``ops.adamw_update``): the
    reference's ``upd`` in float32 -- the gradient times the clip scale,
    the moments, ``delta = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p``
    and ``p - lr * delta`` rounded to p's dtype -- as a few tensor ops,
    each a pass over the leaf."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    den = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
    delta = torch.div(m, b1c).div_(den)
    p32 = p.float()
    delta.add_(p32, alpha=cfg.weight_decay)
    p32.sub_(delta.mul_(lr))
    if p32 is not p:
        p.copy_(p32)
