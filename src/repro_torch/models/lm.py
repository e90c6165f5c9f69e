"""Decoder-only LM on the paged KV cache: dense, MoE, GQA/MQA and MLA.

Counterpart of ``repro.models.lm.DecoderLM`` for the decoder family:
gemma-2b; gemma2/3-style local/global windows, dual rope theta,
softcaps, post-norms and qwen3/gemma3 qk-norm; dense MLA (minicpm3-4b:
one latent stream per token in the paged pool, absorbed decode); MoE
(qwen3-moe-30b-a3b; deepseek-v2-lite with MLA, shared experts and a
leading dense layer); the image-prefixed VLM (internvl2-1b: precomputed
patch embeddings, projected by ``img_proj`` and prepended to the prompt
by ``forward_hidden``/``prefill``/``loss``; suffix prefill and decode
embed text tokens only).  On a mesh's model axis (the train, forward,
serve and prefill steps, ``launch/steps.py``) the same entry points run
on a rank's pieces: the embedding is vocab-parallel
(``shardings.vocab_lookup``), the head gives this rank's vocabulary
piece of the logits and the loss sums over the model axis
(``common.chunked_lm_loss(vocab_parallel=True)``), attention, the MLP
and the MoE feed-forward are Megatron-split (``models/attention.py``,
``common.mlp``, ``models/moe_sharded.py``), training keeps the residual
stream in sequence pieces (``forward_hidden``), and
``shardings.constrain`` checks activations where the reference
constrains them.  Under ``mla_latent_tp`` an MLA model keeps its pool
split into the lora and rope streams (``kv_config``), decodes through
``attention.mla_decode_split`` and writes the two parts of the prefill's
latent stream apart; on the model axis a rank's pool then holds its lora
lanes (``launch/steps.py``).

Differences in form, not in arithmetic:

* parameters are a plain dict of tensors with the reference's tree and
  layouts: per-layer weights stacked on a leading axis, the leading
  dense MLP layers of an MoE model (``moe.first_dense_layers``) in
  ``p["dense_layers"]`` and the rest in ``p["layers"]``, whose layer j
  is global layer ``n_dense + j`` (its window, rope theta and slot of
  the pools); a Python loop over layers replaces ``lax.scan``;
* there is no jit: every entry point runs eagerly, and the KV pools of
  the ``PagedKVCache`` are updated IN PLACE (the reference donates them
  to a functional update) -- ``prefill``, ``prefill_suffix``,
  ``decode_step`` and ``decode_fused`` all write into ``cache.k_pool``
  / ``cache.v_pool`` and return a cache sharing those tensors.  The
  serving layer captures ``decode_fused`` as one CUDA graph per update
  width (``serve/decode_graph.py``), the counterpart of the reference's
  jitted trace, so it also splices and advances the tables and lengths
  in place;
* GQA decode runs the fused ``paged_attention_append`` kernel per layer
  and suffix prefill the ``paged_prefill_attention`` kernel; MLA decode
  writes the latent row and runs the ``paged_attention`` kernel in
  latent mode (see ``models/attention.py``), or, over the split pool,
  the two split-latent kernels.  MLA has no suffix prefill:
  a forked child recomputes its whole prompt, as in the reference.
  ``plain=True`` routes every attention call to its plain PyTorch
  version instead, the comparison path for the kernels.  The MoE
  feed-forward (``models/moe.py``) is plain PyTorch on both paths.

Training: ``loss`` is the reference's (mean next-token NLL through
``chunked_lm_loss``, plus the MoE router's aux term), on
``forward_hidden(with_aux=True)``.  ``forward_hidden`` splits each
stacked leaf once with ``unstack_layers`` (one ``stack`` in the backward
pass, where per-layer indexing would add a zero tensor of the whole leaf
per layer) and, with ``remat=True``, recomputes each layer in the
backward pass.  It runs full-prompt attention and no kernel and writes
no pool; decode keeps ``layer_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_kv import PagedKVCache, PagedKVConfig
from repro_torch.device import resolve_or_meta
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import shardings as SH
from repro_torch.models import attention as A
from repro_torch.models.common import (Params, chunked_lm_loss, dense_init,
                                       embed_tokens, init_mlp, mlp, rmsnorm,
                                       trunc_normal)
from repro_torch.models.common import (EMBED_AXES, MLP_AXES, Stacked,
                                       meta_specs, seeded_generator)
from repro_torch.models.common import remat as remat_fn
from repro_torch.models.moe import MOE_AXES, init_moe
from repro_torch.models.moe_sharded import moe_ffn_dispatch


def layer_params(p: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked per-layer parameter tree."""
    if isinstance(p, dict):
        return {k: layer_params(v, i) for k, v in p.items()}
    return p[i]


def unstack_layers(p: Params) -> List[Params]:
    """Every layer's view of the stacked tree, each leaf split once with
    ``unbind(0)``: the training path's ``layer_params``.  Autograd takes
    the backward pass of one ``unbind`` as one ``stack`` of the layers'
    gradients, where each ``p[i]`` would add a zero tensor of the whole
    stacked leaf per layer."""
    if isinstance(p, dict):
        cols = {k: unstack_layers(v) for k, v in p.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(p.unbind(0))


class DecoderLM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False):
        if cfg.attention not in ("gqa", "mla"):
            raise NotImplementedError(
                f"{cfg.name}: attention {cfg.attention!r} is not ported")
        self.cfg = cfg
        self.is_moe = cfg.moe is not None
        #: leading dense-MLP layers of an MoE model, then the rest
        self.n_dense = cfg.moe.first_dense_layers if self.is_moe else 0
        self.n_scan = cfg.num_layers - self.n_dense
        #: where the attention kernels come from: ``ops`` (kernels on
        #: CUDA, plain versions on CPU) or ``ref`` (plain everywhere)
        self.kernels = kref if plain else ops
        # per global layer; the leading dense layers take no window and
        # the default theta, as in the reference
        local = [i >= self.n_dense and cfg.layer_is_local(i)
                 for i in range(cfg.num_layers)]
        self.windows: List[int] = [(cfg.local_window or 0) if loc else 0
                                   for loc in local]
        self.thetas: List[float] = [
            cfg.rope_theta_local if loc and cfg.rope_theta_local
            else cfg.rope_theta for loc in local]

    @property
    def _attn_axes(self):
        return A.MLA_AXES if self.cfg.attention == "mla" else A.GQA_AXES

    def param_specs(self):
        """(the parameter tree as meta tensors, its logical-axes tree):
        the reference's ``param_specs``, leaf for leaf, without
        allocating."""
        return meta_specs(self, {
            **EMBED_AXES, "img_proj": ("embed", "embed"),
            "layers": Stacked({"attn": self._attn_axes,
                               "ff": MOE_AXES if self.is_moe else MLP_AXES}),
            "dense_layers": Stacked({"attn": self._attn_axes,
                                     "ff": MLP_AXES})})

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (truncated normals as the reference draws them; the
        numbers differ from JAX's -- tests convert the reference's
        parameters with ``models/convert.py`` instead).  Each stacked
        tensor is allocated once and filled layer by layer, so the peak
        is the weights plus one layer (Qwen3-30B-A3B's 61 GB in bf16
        fit one 80 GB card; stacking whole layers would double them)."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        g = seeded_generator(dev, seed)
        dt, d = cfg.torch_dtype, cfg.d_model
        p: Params = {
            "embed": trunc_normal((cfg.vocab_size, d), 1.0, dt, dev, g),
            "final_norm": torch.zeros(d, dtype=dt, device=dev)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(g, d, cfg.vocab_size, dt, dev)
        p["layers"] = _init_stacked(
            lambda: self._init_layer(g, dev, self.is_moe), self.n_scan)
        if self.n_dense:
            p["dense_layers"] = _init_stacked(
                lambda: self._init_layer(g, dev, False), self.n_dense)
        if cfg.num_image_tokens:
            p["img_proj"] = dense_init(g, d, d, dt, dev)
        return p

    def _init_layer(self, g, dev, moe_layer: bool) -> Params:
        cfg = self.cfg
        dt, d = cfg.torch_dtype, cfg.d_model
        init_attn = A.init_mla if cfg.attention == "mla" else A.init_gqa
        attn = init_attn(g, cfg, dev)
        ff = (init_moe(g, cfg, dev) if moe_layer else
              init_mlp(g, d, cfg.d_ff, dt, dev))
        lp = {"attn": attn, "ff": ff,
              "ln1": torch.zeros(d, dtype=dt, device=dev),
              "ln2": torch.zeros(d, dtype=dt, device=dev)}
        if cfg.post_norms:
            lp["ln1_post"] = torch.zeros(d, dtype=dt, device=dev)
            lp["ln2_post"] = torch.zeros(d, dtype=dt, device=dev)
        return lp

    def iter_layers(self, p: Params):
        """(global layer index, that layer's parameters), in order: the
        leading dense layers, then ``p["layers"]``."""
        for i in range(self.n_dense):
            yield i, layer_params(p["dense_layers"], i)
        for j in range(self.n_scan):
            yield self.n_dense + j, layer_params(p["layers"], j)

    # ---------------- embedding / head ----------------
    def _embed(self, p: Params, tokens: torch.Tensor,
               image_embeds: Optional[torch.Tensor] = None,
               seq_parallel: bool = False) -> torch.Tensor:
        """Token embeddings (B, S, d); with ``image_embeds`` (B, I, d)
        the projected image tokens are prepended: (B, I + S, d).  A
        table that holds a vocabulary piece is looked up vocab-parallel
        (``shardings.vocab_lookup``).  ``seq_parallel``: this model
        rank's sequence piece (B, (I +) S / tp, d) only -- of the
        prefixed stream, so the text is embedded whole first (its
        vocab-parallel sum an all-reduce, not a reduce-scatter)."""
        prefix = image_embeds is not None
        x = embed_tokens(p, tokens, self.cfg.vocab_size,
                         seq_parallel and not prefix)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        if prefix:
            img = torch.as_tensor(image_embeds, device=x.device).to(
                x.dtype) @ p["img_proj"]
            x = torch.cat([img, x], dim=1)
            if seq_parallel:
                x = SH.seq_piece(x, 1)
        return x

    def _text_positions(self, x: torch.Tensor, S: int) -> torch.Tensor:
        """The text positions (B, S, ...) of a stream that leads with the
        config's ``num_image_tokens`` image positions (none without an
        image prefix): where ``x`` is this rank's sequence piece, the
        whole stream is gathered first, since a piece of the prefixed
        stream does not end where the image does."""
        I = self.cfg.num_image_tokens
        if SH.is_piece(x, I + S, dim=1):        # a sequence piece
            x = SH.seq_gather(x)
        return x[:, I:]

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits in float32, the final softcap applied elementwise: of
        this rank's vocabulary piece where the head holds one."""
        cfg = self.cfg
        w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        logits = (rmsnorm(x, p["final_norm"], cfg.norm_eps,
                          gemma_style=True) @ w).float()
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    def _ffn(self, lp: Params, x: torch.Tensor, y: torch.Tensor, *,
             with_aux: bool = False, seq_parallel: bool = False):
        """Residual tail shared by every entry point: post-attention
        norm, residual, MLP (the MoE feed-forward where the layer has a
        router), post-MLP norm, residual.  ``with_aux`` (the loss's
        path) returns ``(x, the router's aux loss or None)``.
        ``seq_parallel``: ``x`` and ``y`` are this rank's sequence
        piece."""
        cfg = self.cfg
        if cfg.post_norms:
            y = rmsnorm(y, lp["ln1_post"], cfg.norm_eps, gemma_style=True)
        x = x + y
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps, gemma_style=True)
        aux = None
        if "router" in lp["ff"]:
            y = moe_ffn_dispatch(lp["ff"], h.reshape(-1, *h.shape[-2:]),
                                 cfg, with_aux=with_aux,
                                 seq_parallel=seq_parallel)
            if with_aux:
                y, aux = y
            y = y.reshape(h.shape)
        else:
            y = mlp(h, lp["ff"], cfg.mlp,
                    split=lp["ff"]["wi"].shape[-1] != cfg.d_ff,
                    seq_parallel=seq_parallel)
        if cfg.post_norms:
            y = rmsnorm(y, lp["ln2_post"], cfg.norm_eps, gemma_style=True)
        return (x + y, aux) if with_aux else x + y

    # ---------------- forward (prefill, training) ----------------
    def _attn(self, lp: Params, x: torch.Tensor, i: int,
              positions: torch.Tensor, seq_parallel: bool = False):
        """Layer ``i``'s pre-norm and full-prompt attention: (y, kv),
        kv = (k, v), or (latent, None) for MLA."""
        cfg = self.cfg
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps, gemma_style=True)
        if cfg.attention == "mla":
            y, latent = A.mla_fwd_kv(lp["attn"], h, cfg, positions=positions,
                                     seq_parallel=seq_parallel)
            return y, (latent, None)        # the one latent stream
        return A.gqa_fwd_kv(lp["attn"], h, cfg, window=self.windows[i],
                            positions=positions, rope_theta=self.thetas[i],
                            seq_parallel=seq_parallel)

    def _layer(self, i: int, lp: Params, x: torch.Tensor,
               positions: torch.Tensor, with_aux: bool,
               seq_parallel: bool = False):
        """Layer ``i``: (x, kv as ``_attn`` gives it, the router's aux
        loss where ``with_aux`` and the layer has a router, else None).
        ``seq_parallel``: ``x`` is this rank's sequence piece, the carry
        that ``remat`` keeps."""
        y, kv = self._attn(lp, x, i, positions, seq_parallel)
        if not with_aux:
            return self._ffn(lp, x, y, seq_parallel=seq_parallel), kv, None
        x, aux = self._ffn(lp, x, y, with_aux=True, seq_parallel=seq_parallel)
        return x, kv, aux

    def forward_hidden(self, p: Params, tokens: torch.Tensor, *,
                       image_embeds: Optional[torch.Tensor] = None,
                       collect_kv: bool = False, remat: bool = False,
                       with_aux: bool = False):
        """tokens (B, S) -> (final hidden (B, S, d), aux, [(k, v)] per
        layer -- (latent, None) for MLA -- or None).  A model with
        ``cfg.num_image_tokens`` takes ``image_embeds`` (B, I, d), and
        only it: the image tokens lead, so S becomes I + S.

        The layers come from ``unstack_layers``.  ``with_aux`` (the
        loss's path) sums the MoE layers' router loss into ``aux``
        (float32 0-d; the leading dense layers add none), as the
        reference's scan does; otherwise ``aux`` is None.  ``remat=True``
        recomputes each layer of ``p["layers"]`` in the backward pass, as
        the reference's ``jax.checkpoint(body)``.

        On a model axis whose rules map ``seq`` onto it (the train and
        forward steps) and that divides S, the residual stream is this
        rank's sequence piece (B, S / tp, d) from the embedding on, the
        reference's sequence parallelism (its ``constrain(x, "batch",
        "seq", None)`` after each half of a layer); the hidden comes
        back as that piece.  With an image prefix the piece is one of the
        I + S positions, the image's among them, as the reference
        constrains the prefixed stream."""
        if bool(self.cfg.num_image_tokens) != (image_embeds is not None):
            raise ValueError(
                f"{self.cfg.name}: image_embeds go with a config of "
                f"num_image_tokens > 0 (here {self.cfg.num_image_tokens}), "
                f"and such a config needs them")
        S = tokens.shape[1] + (0 if image_embeds is None
                               else image_embeds.shape[1])
        sp = SH.seq_parallel(S)
        x = SH.constrain(self._embed(p, tokens, image_embeds, sp), "batch",
                         "seq", None)
        positions = torch.arange(S, device=x.device)[None, :]
        stacks = ([p["dense_layers"]] if self.n_dense else []) + [p["layers"]]
        layers = [lp for st in stacks for lp in unstack_layers(st)]
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if with_aux else None)
        kvs = []
        for i, lp in enumerate(layers):
            args = (i, lp, x, positions, with_aux, sp)
            x, kv, a = (remat_fn(self._layer, *args)
                        if remat and i >= self.n_dense else self._layer(*args))
            x = SH.constrain(x, "batch", "seq", None)
            if a is not None:
                aux = aux + a
            if collect_kv:
                kvs.append(kv)
        return x, aux, (kvs if collect_kv else None)

    def forward(self, p: Params, tokens: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S) -> logits (B, S, V) in float32 (B, I + S, V with
        ``image_embeds``)."""
        x, _, _ = self.forward_hidden(p, tokens, image_embeds=image_embeds)
        return self._head(p, x)

    def loss(self, p: Params, batch, *, remat: bool = False):
        """The reference's ``loss``: batch ``{"tokens", "targets"}`` (B, S)
        tensors or arrays, targets -1 masked, and ``"image_embeds"`` (B, I,
        d) for a VLM -> (mean next-token NLL over the text positions plus,
        for MoE, ``router_aux_coef * aux / n_scan``, {"nll": that same
        loss, "aux": aux}), float32 0-d tensors."""
        cfg = self.cfg
        dev = p["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        targets = torch.as_tensor(batch["targets"], device=dev)
        x, aux, _ = self.forward_hidden(
            p, tokens, image_embeds=batch.get("image_embeds"), remat=remat,
            with_aux=True)
        xn = self._text_positions(        # loss on text positions only
            rmsnorm(x, p["final_norm"], cfg.norm_eps, gemma_style=True),
            targets.shape[1])
        w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        nll, cnt = chunked_lm_loss(xn, w, targets,
                                   final_softcap=cfg.final_softcap,
                                   vocab_parallel=w.shape[1] != cfg.vocab_size)
        loss = nll / cnt.clamp(min=1.0)
        if self.is_moe:
            loss = loss + cfg.moe.router_aux_coef * aux / max(1, self.n_scan)
        return loss, {"nll": loss, "aux": aux}

    # ---------------- serving ----------------
    def kv_config(self, max_seq: int, num_blocks: Optional[int] = None,
                  batch: int = 1, dp_groups: int = 1) -> PagedKVConfig:
        cfg = self.cfg
        bt = cfg.kv_block_tokens
        mbs = (max_seq + bt - 1) // bt
        latent = cfg.attention == "mla"
        split = latent and cfg.mla_latent_tp
        if latent:
            hd = cfg.mla.kv_lora_rank if split else cfg.mla.latent_dim
        else:
            hd = cfg.hd
        return PagedKVConfig(
            num_layers=cfg.num_layers,
            kv_heads=1 if latent else cfg.kv_heads,
            head_dim=hd,
            block_tokens=bt,
            num_blocks=num_blocks if num_blocks else mbs * batch,
            max_blocks_per_seq=mbs, latent=latent,
            latent_rope=cfg.mla.qk_rope_head_dim if split else 0,
            dtype=cfg.torch_dtype, dp_groups=dp_groups)

    def decode_state_specs(self, batch: int, max_seq: int,
                           num_blocks: Optional[int] = None,
                           dp_groups: int = 1) -> PagedKVCache:
        """The decode-time state as meta tensors (shapes and dtypes)."""
        return PagedKVCache.create(
            self.kv_config(max_seq, num_blocks, batch, dp_groups), batch,
            device="meta")

    @property
    def supports_suffix_prefill(self) -> bool:
        """Suffix prefill reads the prefix K/V through the block table:
        GQA/MQA only; MLA falls back to full recompute."""
        return self.cfg.attention != "mla"

    def prefill(self, p: Params, tokens: torch.Tensor, cache: PagedKVCache,
                lengths: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None):
        """Run the prompt and write its whole K/V into the pools (in
        place).  tokens: (B, S); with ``image_embeds`` (B, I, d) the image
        tokens lead the prompt and count in ``lengths``.  The prompt (S,
        or I + S) is block-aligned.  Returns (logits at each row's last prompt
        token (B, V), cache with seq_lens = lengths)."""
        x, _, kvs = self.forward_hidden(p, tokens, image_embeds=image_embeds,
                                        collect_kv=True)
        k_all = torch.stack([k for k, _ in kvs])
        if cache.config.latent_rope:
            # the split pool: the lora stream (this rank's lanes of it)
            # and the rope stream apart
            lora = self.cfg.mla.kv_lora_rank
            cache = cache.write_prefill(
                SH.width_piece(k_all[..., :lora], cache.k_pool.shape[-1]),
                k_all[..., lora:], lengths)
        else:
            v_all = (None if self.cfg.attention == "mla"
                     else torch.stack([v for _, v in kvs]))
            cache = cache.write_prefill(k_all, v_all, lengths)
        idx = (lengths.long() - 1).clamp(min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
        return SH.constrain(self._head(p, last), "batch", "vocab"), cache

    def prefill_suffix(self, p: Params, tokens: torch.Tensor,
                       cache: PagedKVCache, lengths: torch.Tensor,
                       starts: torch.Tensor, write_tables: torch.Tensor):
        """Suffix-only prefill: the forward pass over just the un-cached
        tail of each prompt, attending through the block table to the
        COW-shared prefix blocks.  tokens: (B, SQ) block-aligned; row
        b's token i sits at starts[b] + i; lengths (B,) full prompt
        lengths; write_tables (B, SQ // bt) destinations of the suffix
        K/V (the sink where a block is aliased).  Returns (last logits
        (B, V), cache with seq_lens = lengths)."""
        cfg = self.cfg
        if not self.supports_suffix_prefill:
            raise NotImplementedError(
                f"{cfg.name}: suffix prefill is GQA/MQA-only; MLA recomputes "
                f"the whole prompt")
        x = SH.constrain(self._embed(p, tokens), "batch", None, None)
        tables = cache.global_ids(cache.block_tables)
        write_tables = cache.global_ids(write_tables)
        for i, lp in self.iter_layers(p):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps, gemma_style=True)
            y = A.gqa_prefill_paged(
                lp["attn"], h, cfg, cache.k_pool[i], cache.v_pool[i], tables,
                lengths, starts, write_tables, window=self.windows[i],
                rope_theta=self.thetas[i], kernels=self.kernels)
            x = SH.constrain(self._ffn(lp, x, y), "batch", None, None)
        cache = dataclasses.replace(cache, seq_lens=lengths.to(torch.int32))
        idx = (lengths.long() - starts.long() - 1).clamp(min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
        return SH.constrain(self._head(p, last), "batch", "vocab"), cache

    def decode_step(self, p: Params, tokens: torch.Tensor,
                    cache: PagedKVCache, *, in_place: bool = False):
        """tokens (B,) -> (logits (B, V), cache with seq_lens + 1); each
        layer appends its K/V to the pools in place.  ``in_place=True``
        also advances ``cache.seq_lens`` in place and returns ``cache``
        itself (a captured graph replays the addresses it recorded)."""
        cfg = self.cfg
        x = SH.constrain(self._embed(p, tokens), "batch", None)
        tables, lens = cache.global_ids(cache.block_tables), cache.seq_lens
        for i, lp in self.iter_layers(p):
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps, gemma_style=True)
            if cache.config.latent_rope:
                y = A.mla_decode_split(lp["attn"], h, cfg, cache.k_pool[i],
                                       cache.v_pool[i], tables, lens,
                                       kernels=self.kernels)
            elif cfg.attention == "mla":
                y = A.mla_decode(lp["attn"], h, cfg, cache.k_pool[i], tables,
                                 lens, kernels=self.kernels)
            else:
                y = A.gqa_decode(lp["attn"], h, cfg, cache.k_pool[i],
                                 cache.v_pool[i], tables, lens,
                                 window=self.windows[i],
                                 rope_theta=self.thetas[i],
                                 kernels=self.kernels)
            x = SH.constrain(self._ffn(lp, x, y), "batch", None)
        if in_place:
            lens.add_(1)
        else:
            cache = dataclasses.replace(cache, seq_lens=lens + 1)
        return SH.constrain(self._head(p, x), "batch", "vocab"), cache

    def decode_fused(self, p: Params, tokens: torch.Tensor,
                     cache: PagedKVCache, upd_slots: torch.Tensor,
                     upd_tables: torch.Tensor, upd_lens: torch.Tensor):
        """Resident decode tail, the body that the serving layer replays
        from one captured CUDA graph per update width W: splice the W
        update entries' table rows and lengths into the cache in place,
        run one decode step over its first B = len(tokens) rows, advance
        their lengths in place and take the argmax on the device.  The
        cache's tables and lengths may hold scratch rows past B: a pad
        entry names one (slot >= B), so it is dropped on the device, as
        the reference's ``mode="drop"`` drops it.  No shape depends on
        the data and nothing waits for the host.  Returns
        ``(next_tokens (B,) on the device, cache)``, the cache advanced
        in place."""
        B = tokens.shape[0]
        if upd_slots.numel():
            idx = upd_slots.long()
            cache.block_tables.index_copy_(0, idx, upd_tables.to(torch.int32))
            cache.seq_lens.index_copy_(0, idx, upd_lens.to(torch.int32))
        view = dataclasses.replace(cache, block_tables=cache.block_tables[:B],
                                   seq_lens=cache.seq_lens[:B])
        logits, _ = self.decode_step(p, tokens, view, in_place=True)
        return torch.argmax(logits, dim=-1), cache


def _init_stacked(make_layer: Callable[[], Params], n: int) -> Params:
    """``n`` layers from ``make_layer``, stacked on a leading axis: each
    stacked tensor is allocated once and filled as the layers come."""
    first = make_layer()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make_layer(), i)
    return out
