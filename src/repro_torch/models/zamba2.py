"""Zamba2 hybrid: Mamba2 backbone + one SHARED attention/MLP block applied
every ``shared_attn_every`` layers with per-invocation LoRA adapters.

Counterpart of ``repro.models.zamba2.Zamba2LM``.  ``num_layers`` Mamba2
layers in G = L / every groups; after each group the shared transformer
block runs (weights shared across all G invocations; a per-group LoRA
on wq/wk/wv differentiates them).  The shared block's KV cache is G
paged streams in one pool (``kv_config``: one pool layer per
invocation).

Decode state: conv (G,per,B,W-1,cd) + ssd (G,per,B,H,P,N), float32, and
a ``PagedKVCache`` with num_layers = G.  Serving keeps the recurrent
state in a constant-state pool and the KV in the paged pool
(``CompositeStrategy`` in ``serve/arch.py``).

Where the reference decodes the shared attention through jnp
``gqa_decode`` + ``write_token_paged``, ``decode_step`` here runs the
fused ``paged_attention_append`` kernel (#1) per invocation, as
``DecoderLM`` does (``plain=True`` routes it to the plain version).
Prefill stays full-prompt attention (``gqa_fwd_kv``), as in the
reference.  Parameters, the layer loop and eager execution as in
``models/lm.py``; the KV pools are updated in place.

On a mesh's model axis (the train, forward, serve and prefill steps)
the Mamba2 layers split by heads as ``Mamba2LM``'s do, the shared block
runs as the decoder LMs' does (``models/attention.py``, ``common.mlp``:
split heads, or context-parallel attention where they do not divide the
axis), each rank adds its columns of a group's LoRA product to its
pieces of ``wq``/``wk``/``wv`` (``lora_b`` is whole; its columns are
taken by the rank's heads), the tied embedding is vocab-parallel, and a
rank's ``ZambaState`` holds its conv channels, its heads' SSD state and
the KV heads its query heads read, so decode runs #1 over those.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_kv import PagedKVCache, PagedKVConfig
from repro_torch.device import resolve_or_meta
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import shardings as SH
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M2
from repro_torch.models.common import (Params, dense_init, embed_tokens,
                                       mlp, rmsnorm, trunc_normal)
from repro_torch.models.common import (EMBED_AXES, MLP_AXES, Stacked,
                                       meta_specs, seeded_generator)
from repro_torch.models.common import remat as remat_fn
from repro_torch.models.lm import _init_stacked, layer_params, unstack_layers
from repro_torch.models.mamba2_lm import _last, _lm_loss


@dataclasses.dataclass
class ZambaState:
    conv: torch.Tensor       # (G, per, B, W-1, conv_dim)
    ssd: torch.Tensor        # (G, per, B, H, P, N)
    kv: PagedKVCache         # L = G streams


class Zamba2LM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False):
        assert cfg.shared_attn_every > 0
        assert cfg.num_layers % cfg.shared_attn_every == 0
        self.cfg = cfg
        self.groups = cfg.num_layers // cfg.shared_attn_every
        self.per = cfg.shared_attn_every
        #: where the decode attention goes: ``ops`` (the kernel on CUDA,
        #: the plain version on CPU) or ``ref`` (plain everywhere)
        self.kernels = kref if plain else ops

    def param_specs(self):
        """(the parameter tree as meta tensors, its logical-axes tree):
        the reference's ``param_specs``, leaf for leaf, without
        allocating."""
        return meta_specs(self, {
            **EMBED_AXES,
            "lora": Stacked({f"{w}_{ab}": ("embed", None) if ab == "a"
                             else (None, "embed")
                             for w in "qkv" for ab in "ab"}),
            "mamba_layers": Stacked({"mamba": M2.MAMBA2_AXES}, depth=2),
            "shared": {"attn": A.GQA_AXES, "ff": MLP_AXES}})

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device``, in the reference's tree and scales (the LoRA ``*_b``
        factors start at zero, as there)."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        g = seeded_generator(dev, seed)
        dt, d, rk = cfg.torch_dtype, cfg.d_model, cfg.shared_attn_lora
        p: Params = {
            "embed": trunc_normal((cfg.vocab_size, d), 1.0, dt, dev, g),
            "final_norm": torch.zeros(d, dtype=dt, device=dev)}
        flat = _init_stacked(
            lambda: {"mamba": M2.init_mamba2(g, cfg, dev),
                     "ln": torch.zeros(d, dtype=dt, device=dev)},
            cfg.num_layers)
        p["mamba_layers"] = _map(
            lambda t: t.reshape(self.groups, self.per, *t.shape[1:]), flat)
        p["shared"] = {
            "attn": A.init_gqa(g, cfg, dev),
            "ff": {"wi": dense_init(g, d, cfg.d_ff, dt, dev),
                   "wg": dense_init(g, d, cfg.d_ff, dt, dev),
                   "wo": dense_init(g, cfg.d_ff, d, dt, dev)},
            "ln1": torch.zeros(d, dtype=dt, device=dev),
            "ln2": torch.zeros(d, dtype=dt, device=dev)}

        def lora():
            out = {}
            for nm in ("q", "k", "v"):
                out[f"{nm}_a"] = dense_init(g, d, rk, dt, dev, scale=0.01)
                out[f"{nm}_b"] = torch.zeros((rk, d), dtype=dt, device=dev)
            return out

        p["lora"] = _init_stacked(lora, self.groups)
        return p

    # ---------------- shared block ----------------
    def _shared_params(self, shared: Params, lora: Params) -> Params:
        """The shared block's weights with one group's LoRA applied: to
        this rank's columns of ``wq``/``wk``/``wv``, the same columns of
        the LoRA product (``shardings.width_piece`` of ``lora_b``)."""
        sp = dict(shared)
        attn = dict(sp["attn"])
        for nm, w in (("q", "wq"), ("k", "wk"), ("v", "wv")):
            b = SH.width_piece(lora[f"{nm}_b"], attn[w].shape[-1])
            attn[w] = attn[w] + lora[f"{nm}_a"] @ b
        sp["attn"] = attn
        return sp

    def _mlp_tail(self, sp: Params, x: torch.Tensor, y: torch.Tensor,
                  seq_parallel: bool = False):
        cfg = self.cfg
        x = x + y
        h = rmsnorm(x, sp["ln2"], cfg.norm_eps, gemma_style=True)
        return x + mlp(h, sp["ff"], cfg.mlp,
                       split=SH.is_piece(sp["ff"]["wi"], cfg.d_ff),
                       seq_parallel=seq_parallel)

    def _mamba(self, p: Params, g: int, j: int) -> Params:
        return layer_params(layer_params(p["mamba_layers"], g), j)

    # ---------------- forward ----------------
    def _group(self, shared: Params, lora: Params, mls, x: torch.Tensor,
               positions: torch.Tensor, conv=None, ssd=None,
               lengths: Optional[torch.Tensor] = None,
               seq_parallel: bool = False):
        """One group: its Mamba2 layers ``mls`` (from the group's
        ``conv``/``ssd`` state rows, or zeros), then the shared block
        with the group's LoRA.  Returns (x, (conv, ssd) of the group,
        (k, v) of the shared attention).  ``seq_parallel``: ``x`` is
        this rank's sequence piece (``positions`` the whole
        sequence's)."""
        cfg = self.cfg
        gc, gs = [], []
        for j, lp in enumerate(mls):
            cs = ss = None
            if conv is not None:
                cs, ss = conv[j], ssd[j]
            h = rmsnorm(x, lp["ln"], cfg.norm_eps, gemma_style=True)
            y, (cs, ss) = M2.mamba2_fwd(lp["mamba"], h, cfg, cs, ss,
                                        lengths=lengths,
                                        seq_parallel=seq_parallel)
            x = x + y
            gc.append(cs)
            gs.append(ss)
        sp = self._shared_params(shared, lora)
        h = rmsnorm(x, sp["ln1"], cfg.norm_eps, gemma_style=True)
        y, kv = A.gqa_fwd_kv(sp["attn"], h, cfg, window=None,
                             positions=positions, seq_parallel=seq_parallel)
        x = self._mlp_tail(sp, x, y, seq_parallel)
        return x, (torch.stack(gc), torch.stack(gs)), kv

    def forward_hidden(self, p: Params, tokens: torch.Tensor, *,
                       state: Optional[ZambaState] = None,
                       collect_kv: bool = False,
                       lengths: Optional[torch.Tensor] = None,
                       remat: bool = False):
        """tokens (B, S) -> (hidden (B, S, d), (conv, ssd) after them,
        [(k, v)] per shared-block invocation or None).  ``lengths``
        masks right padding out of the SSM scans (padded attention
        outputs are already causal-safe).  The layers and LoRAs come
        from ``unstack_layers``; ``remat=True`` recomputes each group in
        the backward pass, as the reference's
        ``jax.checkpoint(group_body)``.  Sequence parallelism as in
        ``Mamba2LM.forward_hidden``."""
        B, S = tokens.shape
        sp = SH.seq_parallel(S)
        x = SH.constrain(embed_tokens(p, tokens, self.cfg.vocab_size, sp),
                         "batch", "seq", None)
        offs = (state.kv.seq_lens.long() if state is not None
                else torch.zeros(B, dtype=torch.long, device=x.device))
        positions = offs[:, None] + torch.arange(S, device=x.device)[None, :]
        groups = [unstack_layers(g) for g in unstack_layers(p["mamba_layers"])]
        loras = unstack_layers(p["lora"])
        convs, ssds, kvs = [], [], []
        for g in range(self.groups):
            cs = ss = None
            if state is not None:
                cs, ss = state.conv[g], state.ssd[g]
            args = (p["shared"], loras[g], groups[g], x, positions, cs, ss,
                    lengths, sp)
            x, (gc, gs), kv = (remat_fn(self._group, *args) if remat
                               else self._group(*args))
            x = SH.constrain(x, "batch", "seq", None)
            convs.append(gc)
            ssds.append(gs)
            if collect_kv:
                kvs.append(kv)
        return (x, (torch.stack(convs), torch.stack(ssds)),
                kvs if collect_kv else None)

    def loss(self, p: Params, batch, *, remat: bool = False):
        """The reference's ``loss`` (tied head), as ``Mamba2LM.loss``."""
        return _lm_loss(self, p, batch, p["embed"].T, remat)

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return (rmsnorm(x, p["final_norm"], cfg.norm_eps, gemma_style=True)
                @ p["embed"].T).float()

    def forward(self, p: Params, tokens: torch.Tensor, **kw):
        """tokens (B, S) -> (logits (B, S, V) float32, (conv, ssd))."""
        x, state, _ = self.forward_hidden(p, tokens, **kw)
        return self._head(p, x), state

    # ---------------- serving ----------------
    def kv_config(self, max_seq: int, num_blocks: Optional[int] = None,
                  batch: int = 1, dp_groups: int = 1) -> PagedKVConfig:
        cfg = self.cfg
        bt = cfg.kv_block_tokens
        mbs = (max_seq + bt - 1) // bt
        return PagedKVConfig(
            num_layers=self.groups, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
            block_tokens=bt, num_blocks=num_blocks or mbs * batch,
            max_blocks_per_seq=mbs, dtype=cfg.torch_dtype,
            dp_groups=dp_groups)

    def init_state(self, batch: int, max_seq: int,
                   num_blocks: Optional[int] = None, dp_groups: int = 1,
                   device="cuda") -> ZambaState:
        """Zero recurrent state and empty pools (tables NULL)."""
        conv, ssd = self.init_recurrent(batch, device=device)
        kv = PagedKVCache.create(
            self.kv_config(max_seq, num_blocks, batch, dp_groups), batch,
            device=resolve_or_meta(device))
        return ZambaState(conv, ssd, kv)

    def decode_state_specs(self, batch: int, max_seq: int,
                           num_blocks: Optional[int] = None,
                           dp_groups: int = 1) -> ZambaState:
        """The decode-time state as meta tensors (shapes and dtypes)."""
        return self.init_state(batch, max_seq, num_blocks, dp_groups,
                               device="meta")

    def init_recurrent(self, batch: int, device="cuda"):
        """Zero (conv, ssd) recurrent state without a KV pool -- serving
        composes these with an externally owned ``PagedKVCache`` view
        (serve/arch.CompositeStrategy)."""
        d_inner, H, P, N, W = M2._dims(self.cfg)
        dev = resolve_or_meta(device)
        conv = torch.zeros((self.groups, self.per, batch, W - 1,
                            d_inner + 2 * N), dtype=torch.float32,
                           device=dev)
        ssd = torch.zeros((self.groups, self.per, batch, H, P, N),
                          dtype=torch.float32, device=dev)
        return conv, ssd

    def prefill(self, p: Params, tokens: torch.Tensor, state: ZambaState,
                lengths: torch.Tensor):
        """Right-padded prompts: the recurrent state at each row's own
        length and every invocation's K/V written into the pools (in
        place).  tokens (B, S), S block- and chunk-aligned.  Returns
        (logits at each row's last prompt token (B, V), ZambaState)."""
        x, (conv, ssd), kvs = self.forward_hidden(
            p, tokens, state=state, collect_kv=True, lengths=lengths)
        kv = state.kv.write_prefill(torch.stack([k for k, _ in kvs]),
                                    torch.stack([v for _, v in kvs]),
                                    lengths)
        return self._head(p, _last(x, lengths)), ZambaState(conv, ssd, kv)

    def decode_step(self, p: Params, tokens: torch.Tensor,
                    state: ZambaState, *, in_place: bool = False):
        """tokens (B,) -> (logits (B, V), advanced ZambaState); each
        invocation appends its K/V to its pool layer in place.
        ``in_place=True`` also advances ``state.kv.seq_lens`` in place and
        keeps ``state.kv`` in the returned state (the serving tail, which
        a captured graph replays)."""
        cfg = self.cfg
        x = embed_tokens(p, tokens, cfg.vocab_size)
        cache = state.kv
        tables, lens = cache.global_ids(cache.block_tables), cache.seq_lens
        convs, ssds = [], []
        for g in range(self.groups):
            gc, gs = [], []
            for j in range(self.per):
                lp = self._mamba(p, g, j)
                h = rmsnorm(x, lp["ln"], cfg.norm_eps, gemma_style=True)
                y, (cs, ss) = M2.mamba2_step(lp["mamba"], h, cfg,
                                             state.conv[g, j],
                                             state.ssd[g, j])
                x = x + y
                gc.append(cs)
                gs.append(ss)
            convs.append(torch.stack(gc))
            ssds.append(torch.stack(gs))
            sp = self._shared_params(p["shared"], layer_params(p["lora"], g))
            h = rmsnorm(x, sp["ln1"], cfg.norm_eps, gemma_style=True)
            y = A.gqa_decode(sp["attn"], h, cfg, cache.k_pool[g],
                             cache.v_pool[g], tables, lens,
                             kernels=self.kernels)
            x = self._mlp_tail(sp, x, y)
        if in_place:
            lens.add_(1)
        else:
            cache = dataclasses.replace(cache, seq_lens=lens + 1)
        return self._head(p, x), ZambaState(torch.stack(convs),
                                            torch.stack(ssds), cache)

    # -- constant-state pool glue (serve/arch.CompositeStrategy) --
    @property
    def state_elems(self) -> int:
        """Float32 elements of ONE sequence's recurrent state -- the
        constant-state pool's (exact) block quantum."""
        d_inner, H, P, N, W = M2._dims(self.cfg)
        per_layer = (W - 1) * (d_inner + 2 * N) + H * P * N
        return self.groups * self.per * per_layer

    def state_to_rows(self, conv: torch.Tensor,
                      ssd: torch.Tensor) -> torch.Tensor:
        """Flatten (G, per, B, ...) recurrent state to per-sequence
        (B, state_elems) rows -- one pool block per sequence."""
        B = conv.shape[2]
        c = conv.movedim(2, 0).reshape(B, -1)
        s = ssd.movedim(2, 0).reshape(B, -1)
        return torch.cat([c, s], dim=1).float()

    def rows_to_state(self, rows: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inverse of ``state_to_rows`` (views of ``rows``)."""
        d_inner, H, P, N, W = M2._dims(self.cfg)
        G, per = self.groups, self.per
        B = rows.shape[0]
        cd = d_inner + 2 * N
        csize = G * per * (W - 1) * cd
        conv = rows[:, :csize].reshape(B, G, per, W - 1, cd).movedim(0, 2)
        ssd = rows[:, csize:].reshape(B, G, per, H, P, N).movedim(0, 2)
        return conv, ssd


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
