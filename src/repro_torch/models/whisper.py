"""Whisper-tiny backbone: an encoder-decoder transformer.

Counterpart of ``repro.models.whisper``.  The conv/mel frontend is a
stub, as in the reference: ``frames`` arrive as precomputed (B, F, d)
embeddings.  The encoder adds sinusoidal positions and runs
bidirectional layers; the decoder adds learned positions (``p["pos"]``,
``max_positions`` rows) and runs causal self attention, then cross
attention over the encoder output, then the MLP.  Rope is off
(``rope_theta`` 0).

Serving state (``WhisperState``): the decoder's self-attention K/V grows
token by token in the paged pool (``PagedKVCache``), and each decode step
appends through the fused ``paged_attention_append`` kernel (#1); the
cross-attention K/V is computed once at prefill from the encoder output
and kept dense, (L, B, F, KVH, hd), as the reference keeps it -- it never
grows.  The registry documents its discipline as a read-only segment
(``serve/arch.py``: ``ReadOnlySegment``) and does not serve it, as in the
reference.

On a mesh's model axis (the train, forward, serve and prefill steps,
``launch/steps.py``) the same entry points run on a rank's pieces, as
``models/lm.py``'s do: the embedding is vocab-parallel where the axis
divides the vocabulary (``common.embed_tokens``), the head gives this
rank's vocabulary piece and the loss sums over the model axis; each
attention -- the encoder's, the decoder's self and cross attention --
runs over the rank's heads and each layer's ``wo`` and MLP
down-projection are row-parallel sums (three a decoder layer).  The
cross K/V is computed at prefill from the rank's ``xattn`` ``wk``/``wv``
columns and kept as its ``(L, B, F, KVH / tp, hd)``.  Where the heads do
not divide the axis the attention weights replicate and the prompt's
attention goes context-parallel.  The train and forward steps keep the
encoder's frames and the decoder's tokens in sequence pieces where the
axis divides each (``shardings.seq_parallel``; what does not divide
stays whole); the encoder output is gathered once for every decoder
layer's cross K/V.

Differences in form, as in ``models/lm.py``: a dict of tensors with the
reference's tree (encoder layers stacked as ``enc_layers``, decoder
layers as ``dec_layers``), Python loops over layers, no jit, and the
self-attention pools updated IN PLACE by ``prefill`` and
``decode_step``.  ``plain=True`` runs the plain versions of the kernels
(``kernels/ref.py``) on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_kv import PagedKVCache, PagedKVConfig
from repro_torch.device import resolve_or_meta
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import shardings as SH
from repro_torch.models import attention as A
from repro_torch.models.common import (Params, chunked_lm_loss,
                                       embed_tokens, init_mlp, mlp, rmsnorm,
                                       sinusoidal_positions, trunc_normal)
from repro_torch.models.common import (EMBED_AXES, MLP_AXES, Stacked,
                                       meta_specs, seeded_generator)
from repro_torch.models.common import remat as remat_fn
from repro_torch.models.lm import _init_stacked, layer_params, unstack_layers


@dataclasses.dataclass
class WhisperState:
    self_kv: PagedKVCache            # decoder self attention, L layers
    cross_k: torch.Tensor            # (L, B, F, KVH, hd)
    cross_v: torch.Tensor


class WhisperModel:
    def __init__(self, cfg: ModelConfig, max_positions: int = 4096, *,
                 plain: bool = False):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: whisper needs an encoder config")
        self.cfg = cfg
        self.max_positions = max_positions
        #: ``ops`` (kernels on CUDA, plain versions on CPU) or ``ref``
        self.kernels = kref if plain else ops
        #: the encoder's sinusoids on a device, by (F, d, device, dtype):
        #: made on the host once, so a captured train step reads them
        #: and copies nothing from pageable memory
        self._sinusoids: Dict[Tuple, torch.Tensor] = {}

    def param_specs(self):
        """(the parameter tree as meta tensors, its logical-axes tree):
        the reference's ``param_specs``, leaf for leaf, without
        allocating."""
        return meta_specs(self, {
            **EMBED_AXES, "pos": (None, "embed"),
            "enc_layers": Stacked({"attn": A.GQA_AXES, "ff": MLP_AXES}),
            "dec_layers": Stacked({"attn": A.GQA_AXES, "xattn": A.GQA_AXES,
                                   "ff": MLP_AXES})})

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device``, as the reference draws them (the numbers differ from
        JAX's; tests convert the reference's with ``models/convert.py``)."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        g = seeded_generator(dev, seed)
        dt, d = cfg.torch_dtype, cfg.d_model
        pos = torch.empty((self.max_positions, d), dtype=torch.float32,
                          device=dev).normal_(generator=g)
        p: Params = {
            "embed": trunc_normal((cfg.vocab_size, d), 1.0, dt, dev, g),
            "pos": (0.01 * pos).to(dt),
            "enc_norm": torch.zeros(d, dtype=dt, device=dev),
            "final_norm": torch.zeros(d, dtype=dt, device=dev)}
        p["enc_layers"] = _init_stacked(
            lambda: self._init_layer(g, dev, cross=False),
            cfg.encoder.num_layers)
        p["dec_layers"] = _init_stacked(
            lambda: self._init_layer(g, dev, cross=True), cfg.num_layers)
        return p

    def _init_layer(self, g, dev, *, cross: bool) -> Params:
        cfg = self.cfg
        dt, d = cfg.torch_dtype, cfg.d_model
        lp = {"attn": A.init_gqa(g, cfg, dev)}
        if cross:
            lp["xattn"] = A.init_gqa(g, cfg, dev)
        lp["ff"] = init_mlp(g, d, cfg.d_ff, dt, dev)
        for k in ("ln1", "lnx", "ln2") if cross else ("ln1", "ln2"):
            lp[k] = torch.zeros(d, dtype=dt, device=dev)
        return lp

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, w, self.cfg.norm_eps, gemma_style=True)

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits in float32: this rank's vocabulary piece where the
        embedding holds one."""
        return (self._norm(x, p["final_norm"]) @ p["embed"].T).float()

    def _mlp(self, lp: Params, x: torch.Tensor,
             seq_parallel: bool = False) -> torch.Tensor:
        """The layer's MLP on its pre-norm input, Megatron-split where a
        rank holds a piece of the hidden dim."""
        ff = lp["ff"]
        return mlp(x, ff, self.cfg.mlp,
                   split=SH.is_piece(ff["wi"], self.cfg.d_ff),
                   seq_parallel=seq_parallel)

    # ---------------- encoder ----------------
    def encode(self, p: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, d) stub embeddings -> encoder output (B, F, d).
        Where the active rules put the sequence in pieces and the model
        axis divides F (the train and forward steps), the stream is this
        rank's piece (B, F / tp, d) from the positions on, and so is the
        output."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        frames = torch.as_tensor(frames, device=p["embed"].device)
        B, F, d = frames.shape
        key = (F, d, frames.device, dt)
        pos = self._sinusoids.get(key)
        if pos is None:
            pos = self._sinusoids[key] = sinusoidal_positions(F, d).to(
                device=frames.device, dtype=dt)
        x = frames.to(dt) + pos[None]
        sp = SH.seq_parallel(F)
        x = SH.constrain(SH.seq_piece(x, 1) if sp else x, "batch", "frames",
                         None)
        positions = torch.arange(F, device=x.device)[None, :]
        for lp in unstack_layers(p["enc_layers"]):
            y, _ = A.gqa_fwd_kv(lp["attn"], self._norm(x, lp["ln1"]), cfg,
                                window=None, positions=positions,
                                causal=False, seq_parallel=sp)
            x = SH.constrain(x + y, "batch", "frames", None)
            x = SH.constrain(x + self._mlp(lp, self._norm(x, lp["ln2"]), sp),
                             "batch", "frames", None)
        return self._norm(x, p["enc_norm"])

    # ---------------- decoder (training, prefill) ----------------
    def _dec_layer(self, lp: Params, x: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor, seq_parallel: bool = False):
        """One decoder layer over the whole prompt (``seq_parallel``:
        ``x`` is this rank's sequence piece; ``enc`` is always every
        frame): (x, ((k, v) of the self attention, (k, v) of the cross
        attention))."""
        cfg = self.cfg
        sp = seq_parallel
        y, kv = A.gqa_fwd_kv(lp["attn"], self._norm(x, lp["ln1"]), cfg,
                             window=None, positions=positions,
                             seq_parallel=sp)
        x = SH.constrain(x + y, "batch", "seq", None)
        enc_pos = torch.arange(enc.shape[1], device=x.device)[None, :]
        xkv = A.gqa_cross_kv(lp["xattn"], enc, cfg, enc_pos)
        y = A.gqa_cross(lp["xattn"], self._norm(x, lp["lnx"]), xkv, cfg,
                        positions=positions, seq_parallel=sp)
        x = SH.constrain(x + y, "batch", "seq", None)
        x = SH.constrain(x + self._mlp(lp, self._norm(x, lp["ln2"]), sp),
                         "batch", "seq", None)
        return x, (kv, xkv)

    def forward_hidden(self, p: Params, tokens: torch.Tensor, *,
                       frames: torch.Tensor, remat: bool = False,
                       collect_kv: bool = False):
        """tokens (B, S), frames (B, F, d) -> (final hidden (B, S, d),
        [((k, v), (cross k, cross v))] per decoder layer or None).
        ``remat=True`` recomputes each decoder layer in the backward pass,
        as the reference's ``jax.checkpoint(body)``; the encoder's layers
        are not recomputed, as in the reference.  Under sequence
        parallelism (``encode``) the decoder's stream is this rank's
        piece of the S tokens where the model axis divides S, and so is
        the hidden; the encoder output is gathered whole once."""
        cfg = self.cfg
        enc = self.encode(p, frames)
        if SH.is_piece(enc, frames.shape[1], dim=1):
            enc = SH.seq_gather(enc)
        tokens = tokens.long()
        S = tokens.shape[1]
        sp = SH.seq_parallel(S)
        pos = p["pos"][:S][None]
        x = (embed_tokens(p, tokens, cfg.vocab_size, sp)
             + (SH.seq_piece(pos, 1) if sp else pos))
        x = SH.constrain(x, "batch", "seq", None)
        positions = torch.arange(S, device=x.device)[None, :]
        kvs = []
        for lp in unstack_layers(p["dec_layers"]):
            args = (lp, x, enc, positions, sp)
            x, kv = remat_fn(self._dec_layer, *args) if remat else \
                self._dec_layer(*args)
            if collect_kv:
                kvs.append(kv)
        return x, (kvs if collect_kv else None)

    def forward(self, p: Params, tokens: torch.Tensor, *,
                frames: torch.Tensor) -> torch.Tensor:
        """-> logits (B, S, V) in float32."""
        x, _ = self.forward_hidden(p, tokens, frames=frames)
        return self._head(p, x)

    def loss(self, p: Params, batch, *, remat: bool = False):
        """The reference's ``loss``: batch ``{"frames", "tokens",
        "targets"}``, targets -1 masked -> (mean next-token NLL, {"nll":
        the same}), float32 0-d tensors."""
        cfg = self.cfg
        dev = p["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        targets = torch.as_tensor(batch["targets"], device=dev)
        x, _ = self.forward_hidden(p, tokens, frames=batch["frames"],
                                   remat=remat)
        xn = self._norm(x, p["final_norm"])
        if SH.is_piece(xn, targets.shape[1], dim=1):   # a sequence piece
            xn = SH.seq_gather(xn)
        w = p["embed"].T
        nll, cnt = chunked_lm_loss(
            xn, w, targets,
            vocab_parallel=SH.is_piece(w, cfg.vocab_size, dim=1))
        loss = nll / cnt.clamp(min=1.0)
        return loss, {"nll": loss}

    # ---------------- serving ----------------
    def kv_config(self, max_seq: int, num_blocks: Optional[int] = None,
                  batch: int = 1, dp_groups: int = 1) -> PagedKVConfig:
        cfg = self.cfg
        bt = cfg.kv_block_tokens
        mbs = (max_seq + bt - 1) // bt
        return PagedKVConfig(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.hd, block_tokens=bt,
            num_blocks=num_blocks or mbs * batch, max_blocks_per_seq=mbs,
            dtype=cfg.torch_dtype, dp_groups=dp_groups)

    def init_state(self, batch: int, max_seq: int,
                   num_blocks: Optional[int] = None, dp_groups: int = 1,
                   device="cuda") -> WhisperState:
        """Empty self-attention pools (tables NULL) and zero cross K/V."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        kv = PagedKVCache.create(
            self.kv_config(max_seq, num_blocks, batch, dp_groups), batch,
            device=dev)
        shape = (cfg.num_layers, batch, cfg.encoder.num_frames,
                 cfg.kv_heads, cfg.hd)
        return WhisperState(
            kv, torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            torch.zeros(shape, dtype=cfg.torch_dtype, device=dev))

    def decode_state_specs(self, batch: int, max_seq: int,
                           num_blocks: Optional[int] = None,
                           dp_groups: int = 1) -> WhisperState:
        """The decode-time state as meta tensors (shapes and dtypes)."""
        return self.init_state(batch, max_seq, num_blocks, dp_groups,
                               device="meta")

    def prefill(self, p: Params, tokens: torch.Tensor, state: WhisperState,
                lengths: torch.Tensor, *, frames: torch.Tensor):
        """Encode ``frames``, run the prompt (B, S) block-aligned, write its
        self-attention K/V into the pools (in place) and keep the cross
        K/V.  Returns (logits at each row's last prompt token (B, V), the
        state with seq_lens = lengths)."""
        x, kvs = self.forward_hidden(p, tokens, frames=frames,
                                     collect_kv=True)
        k_all = torch.stack([kv[0][0] for kv in kvs])
        v_all = torch.stack([kv[0][1] for kv in kvs])
        cache = state.self_kv.write_prefill(k_all, v_all, lengths)
        cross_k = torch.stack([kv[1][0] for kv in kvs])
        cross_v = torch.stack([kv[1][1] for kv in kvs])
        idx = (lengths.long() - 1).clamp(min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
        return (SH.constrain(self._head(p, last), "batch", "vocab"),
                WhisperState(cache, cross_k, cross_v))

    def decode_step(self, p: Params, tokens: torch.Tensor,
                    state: WhisperState):
        """tokens (B,) -> (logits (B, V), state with seq_lens + 1).  Each
        layer appends its self-attention K/V to the pools in place (#1),
        then attends over the dense cross K/V (not causal)."""
        cfg = self.cfg
        cache = state.self_kv
        tables, lens = cache.global_ids(cache.block_tables), cache.seq_lens
        x = SH.constrain(embed_tokens(p, tokens, cfg.vocab_size)
                         + p["pos"][lens.long()], "batch", None)
        positions = lens.long()[:, None]          # unused: rope is off
        for i in range(cfg.num_layers):
            lp = layer_params(p["dec_layers"], i)
            x = x + A.gqa_decode(lp["attn"], self._norm(x, lp["ln1"]), cfg,
                                 cache.k_pool[i], cache.v_pool[i], tables,
                                 lens, kernels=self.kernels)
            h = self._norm(x, lp["lnx"])[:, None]
            x = x + A.gqa_cross(lp["xattn"], h, (state.cross_k[i],
                                                 state.cross_v[i]), cfg,
                                positions=positions)[:, 0]
            x = x + self._mlp(lp, self._norm(x, lp["ln2"]))
        cache = dataclasses.replace(cache, seq_lens=lens + 1)
        return (SH.constrain(self._head(p, x), "batch", "vocab"),
                WhisperState(cache, state.cross_k, state.cross_v))
