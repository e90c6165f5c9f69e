"""Shared building blocks: init helpers, norms, RoPE, MLPs, attention.

Parameters are plain nested dicts of tensors with the same tree and
layouts as the reference package's (per-layer weights stacked on a
leading L axis), so ``models/convert.py`` maps one onto the other leaf
by leaf.  Arithmetic follows ``repro.models.common``: norms and RoPE in
float32, GeGLU with the tanh-approximated GELU that ``jax.nn.gelu``
uses by default, and attention logits in float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import shardings as SH

Params = Dict[str, Any]

_NEG = -1e30


# -- init --------------------------------------------------------------------
def seeded_generator(device: torch.device,
                     seed: int) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    the meta device, where nothing is drawn (``param_specs``)."""
    if device.type == "meta":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def trunc_normal(shape, scale: float, dtype: torch.dtype, device,
                 generator: torch.Generator) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], drawn in
    float32 from ``generator`` (which must live on ``device``); on the
    meta device nothing is drawn (shapes only: ``param_specs``, whose
    first draw there would load the meta kernels of the sampling ops,
    seconds of host time)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
            gemma_style: bool = False,
            width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over the last dimension, in float32.  ``width``: the
    whole width the norm runs over, where ``x`` and ``weight`` hold this
    model rank's piece of it (heads split over the model axis): the
    mean of squares comes from every rank's piece
    (``shardings.model_sum_squares``)."""
    dt = x.dtype
    x = x.float()
    if width is None or width == x.shape[-1]:
        ms = (x * x).mean(dim=-1, keepdim=True)
    else:
        ms = SH.model_sum_squares(x) / width
    x = x * torch.rsqrt(ms + eps)
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


def sinusoidal_positions(num: int, dim: int) -> torch.Tensor:
    """Whisper-style sinusoids (num, dim), float32 on the CPU: computed
    in float64 numpy as the reference computes them (with its
    ``max(1, dim // 2 - 1)`` denominator), then rounded to float32."""
    inv = 1.0 / (10000 ** (np.arange(dim // 2) / max(1, dim // 2 - 1)))
    pos = np.arange(num)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(pos), np.cos(pos)],
                                           axis=1).astype(np.float32))


# -- MLP -----------------------------------------------------------------------
def init_mlp(generator, d_model: int, d_ff: int, dtype, device) -> Params:
    """The gated MLP's ``wi``, ``wg``, ``wo``, drawn in that order."""
    return {"wi": dense_init(generator, d_model, d_ff, dtype, device),
            "wg": dense_init(generator, d_model, d_ff, dtype, device),
            "wo": dense_init(generator, d_ff, d_model, dtype, device)}


#: logical axes of the MLP's leaves (``repro.models.common.init_mlp``)
MLP_AXES = {"wi": ("embed", "heads"), "wg": ("embed", "heads"),
            "wo": ("heads", "embed")}


def mlp(x: torch.Tensor, p: Params, kind: str = "swiglu", *,
        split: bool = False, seq_parallel: bool = False) -> torch.Tensor:
    """The gated MLP.  ``split``: ``wi``/``wg`` hold this rank's columns
    of the hidden dim and ``wo`` its rows (Megatron over the model
    axis): the down-projection is summed over the ranks
    (``shardings.row_parallel``).  ``seq_parallel``: ``x`` (B, S / tp,
    d) is this rank's sequence piece, gathered before split products
    and given back as the piece after them; whole weights run on the
    piece itself."""
    if split and seq_parallel:
        x = SH.seq_gather(x)
    g = x @ p["wg"]
    act = F.gelu(g, approximate="tanh") if kind == "geglu" else F.silu(g)
    return SH.row_parallel(act * (x @ p["wi"]), p["wo"], split, seq_parallel)


# -- logical axes ----------------------------------------------------------------
class Stacked:
    """An axes table for a subtree whose leaves carry ``depth`` leading
    layer axes (``("layers",) * depth`` before each leaf's own axes)."""

    def __init__(self, table, depth: int = 1):
        self.table, self.depth = table, depth


def logical_axes(tree, table, stack: int = 0):
    """The reference's logical-axes tree for the parameter tree ``tree``
    (the second half of its ``init``): ``table`` mirrors ``tree`` with a
    tuple of axis names for a leaf (without its layer axes), a dict for
    a subtree or a ``Stacked`` table; a leaf the table leaves out is
    replicated, ``(None,) * ndim``."""
    if isinstance(table, Stacked):
        return logical_axes(tree, table.table, stack + table.depth)
    if isinstance(tree, dict):
        sub = table if isinstance(table, dict) else {}
        return {k: logical_axes(v, sub.get(k, {}), stack)
                for k, v in tree.items()}
    own = (table if isinstance(table, tuple)
           else (None,) * (tree.dim() - stack))
    return ("layers",) * stack + own


#: the token embedding and the untied head of every family
EMBED_AXES = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab")}


def meta_specs(model, table) -> Tuple[Params, Params]:
    """(the parameter tree as meta tensors -- shapes and dtypes, no
    storage -- and its logical axes by ``table``): a model's
    ``param_specs``."""
    shapes = model.init(0, device="meta")
    return shapes, logical_axes(shapes, table)


# -- rematerialisation ---------------------------------------------------------
def _requires_grad(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if isinstance(obj, dict):
        return any(_requires_grad(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_requires_grad(v) for v in obj)
    return False


def remat(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``jax.checkpoint``'s counterpart): only its inputs are kept.  A
    plain call where autograd records nothing: under ``no_grad``, or
    when no tensor in ``args`` (dicts and sequences searched) requires
    grad, as on every serving path.  The recomputation runs under the
    sharding rules active at the call (``shardings.restore_rules``):
    on the card autograd runs it on its device thread, where they are
    not set.  No loss path draws random numbers, so the RNG state is not
    stashed (``preserve_rng_state=False``): reading the CUDA generator's
    state is refused inside a CUDA graph capture (the captured train
    step, ``train/step_graph.py``)."""
    if torch.is_grad_enabled() and _requires_grad(args):
        ctx = SH.current_rules()

        def under_rules(*a):
            with SH.restore_rules(ctx):
                return fn(*a)

        return checkpoint(under_rules, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# -- embedding ---------------------------------------------------------------
def embed_tokens(p: Params, tokens: torch.Tensor, vocab: int,
                 seq_parallel: bool = False) -> torch.Tensor:
    """Rows of ``p["embed"]`` for ``tokens``: vocab-parallel where the
    table holds a vocabulary piece (``shardings.vocab_lookup``);
    ``seq_parallel``: this model rank's sequence piece of (B, S)
    ``tokens``."""
    emb = p["embed"]
    if SH.is_piece(emb, vocab, dim=0):
        return SH.vocab_lookup(emb, tokens, seq_parallel)
    return emb[(SH.seq_piece(tokens, 1) if seq_parallel else tokens).long()]


# -- loss ------------------------------------------------------------------------
def _loss_chunk(S: int, target: int = 512) -> int:
    """Largest divisor of S that is <= target."""
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def _loss_body(x: torch.Tensor, head_w: torch.Tensor, targets: torch.Tensor,
               final_softcap: Optional[float]):
    """One chunk: (sum of -log p(target) over unmasked positions, their
    count), both float32 0-d."""
    logits = (x @ head_w).float()
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def _loss_body_vocab_parallel(x: torch.Tensor, head_w: torch.Tensor,
                              targets: torch.Tensor,
                              final_softcap: Optional[float]):
    """``_loss_body`` on this model rank's vocabulary piece of the head
    (ids ``[i * V_l, (i + 1) * V_l)``, i its model position): the
    log-sum-exp's maximum and sum go over the model axis, and the rank
    that owns a target gives its logit.  Every rank returns the whole
    chunk's sums."""
    logits = (x @ head_w).float()
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    mesh = SH.model_mesh()
    vl = logits.shape[-1]
    mask = (targets >= 0).float()
    idx = targets.clamp(min=0).long() - mesh.axis_index("model") * vl
    mine = (idx >= 0) & (idx < vl)
    m = SH.model_all_reduce_max(logits.amax(dim=-1))
    lse = SH.model_all_reduce(
        torch.exp(logits - m[..., None]).sum(dim=-1)).log() + m
    own = logits.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    gold = SH.model_all_reduce(torch.where(mine, own, torch.zeros_like(own)))
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_lm_loss(x: torch.Tensor, head_w: torch.Tensor,
                    targets: torch.Tensor, *,
                    final_softcap: Optional[float] = None,
                    chunk: int = 512, vocab_parallel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materialising (B, S, V) float32 logits.

    x: (B, S, d) FINAL-NORMED hidden; head_w: (d, V); targets: (B, S)
    with -1 = masked.  Runs over sequence chunks of the largest divisor
    of S that is <= ``chunk``; each chunk's logits are recomputed in the
    backward pass (``remat``), so the peak holds one (B, c, V) slab.
    ``vocab_parallel``: ``head_w`` holds this model rank's vocabulary
    piece (d, V / tp), and the sums go over the model axis
    (``_loss_body_vocab_parallel``).  Returns (nll_sum, token_count),
    float32.
    """
    S = x.shape[1]
    c = _loss_chunk(S, chunk)
    body = _loss_body_vocab_parallel if vocab_parallel else _loss_body
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, c):
        n, k = remat(body, x[:, c0:c0 + c], head_w,
                     targets[:, c0:c0 + c], final_softcap)
        nll = nll + n
        cnt = cnt + k
    return nll, cnt


# -- full-prompt attention -----------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Exact attention over a whole prompt (prefill), causal unless
    ``causal=False`` (whisper's encoder and cross attention: every query
    sees every key).  The queries sit at positions ``q_offset`` ..
    ``q_offset + Sq - 1`` of the keys' (a context-parallel piece).

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
    qpos = torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    valid = kpos <= qpos if causal else None
    if window is not None and window > 0:
        inside = kpos > qpos - window
        valid = inside if valid is None else valid & inside
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, -1).to(q.dtype)
