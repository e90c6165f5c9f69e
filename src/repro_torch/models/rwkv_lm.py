"""RWKV6 language model: stacked (time-mix + channel-mix) blocks.

Counterpart of ``repro.models.rwkv_lm.RWKVLM``.  Attention-free: decode
state is O(1) per layer (the wkv matrix state and two token-shift
vectors), served from the constant-state pool discipline
(``ConstantStateStrategy`` in ``serve/arch.py``).  Prefill masks right
padding out of the recurrence and picks the shift vectors at each row's
own last token, so a padded batched prefill is token-identical to
per-sequence prefill.  Parameters, the layer loop and eager execution
as in ``models/mamba2_lm.py``; no kernel of ``kernels/`` runs here.

On a mesh's model axis (the train, forward, serve and prefill steps)
the embedding and the untied ``lm_head`` are vocab-parallel, the time
and channel mixes split by heads (``models/rwkv6.py``), a rank's
``RWKVState`` holds the wkv state of its heads and the shift vectors
whole, and under sequence parallelism (training) the residual stream is
this rank's sequence piece.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_or_meta
from repro_torch.launch import shardings as SH
from repro_torch.models import rwkv6 as R
from repro_torch.models.common import (Params, dense_init, embed_tokens,
                                       rmsnorm, trunc_normal)
from repro_torch.models.common import (EMBED_AXES, Stacked, meta_specs,
                                       seeded_generator)
from repro_torch.models.common import remat as remat_fn
from repro_torch.models.lm import _init_stacked, layer_params, unstack_layers
from repro_torch.models.mamba2_lm import _last, _lm_loss


@dataclasses.dataclass
class RWKVState:
    """Decode state: (L,B,d) shift vectors in the model dtype + the
    (L,B,H,dk,dk) float32 wkv state."""
    mix_x: torch.Tensor
    ffn_x: torch.Tensor
    wkv: torch.Tensor


class RWKVLM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False):
        assert cfg.ssm is not None and cfg.ssm.kind == "rwkv6"
        self.cfg = cfg          # no kernel on this path: ``plain`` is moot

    def param_specs(self):
        """(the parameter tree as meta tensors, its logical-axes tree):
        the reference's ``param_specs``, leaf for leaf, without
        allocating."""
        return meta_specs(self, {
            **EMBED_AXES,
            "layers": Stacked({"mix": R.MIX_AXES, "ffn": R.FFN_AXES})})

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device``, in the reference's tree and scales."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        g = seeded_generator(dev, seed)
        dt, d = cfg.torch_dtype, cfg.d_model
        p: Params = {
            "embed": trunc_normal((cfg.vocab_size, d), 1.0, dt, dev, g),
            "ln_in": torch.zeros(d, dtype=dt, device=dev),
            "final_norm": torch.zeros(d, dtype=dt, device=dev),
            "lm_head": dense_init(g, d, cfg.vocab_size, dt, dev)}
        p["layers"] = _init_stacked(
            lambda: {"mix": R.init_rwkv6_mix(g, cfg, dev),
                     "ffn": R.init_rwkv6_ffn(g, cfg, dev),
                     "ln1": torch.zeros(d, dtype=dt, device=dev),
                     "ln2": torch.zeros(d, dtype=dt, device=dev)},
            cfg.num_layers)
        return p

    # ---------------- forward ----------------
    def _layer(self, lp: Params, x: torch.Tensor, state=None, lengths=None,
               seq_parallel: bool = False):
        """state: None (from zeros) or this layer's (mix_x, ffn_x, wkv);
        ``lengths`` masks right padding out of the recurrence and picks
        the shift vectors at each row's true last position.
        ``seq_parallel``: ``x`` is this rank's sequence piece."""
        cfg = self.cfg
        mix_x, ffn_x, wkv = state if state is not None else (None,) * 3
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps, gemma_style=True)
        y, (last_x, wkv_out) = R.rwkv6_mix_fwd(lp["mix"], h, cfg,
                                               prev_x=mix_x, state_in=wkv,
                                               lengths=lengths,
                                               seq_parallel=seq_parallel)
        x = x + y
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps, gemma_style=True)
        if seq_parallel:
            h = SH.seq_gather(h)
        prev = (ffn_x[:, None] if ffn_x is not None
                else torch.zeros_like(h[:, :1]))
        hh = torch.cat([prev, h[:, :-1]], dim=1)
        x = x + R.rwkv6_ffn(lp["ffn"], h, hh, split=self._ffn_split(lp),
                            seq_parallel=seq_parallel)
        last_h = h[:, -1] if lengths is None else _last(h, lengths)
        return x, (last_x, last_h, wkv_out)

    def _ffn_split(self, lp: Params) -> bool:
        """Whether the channel mix holds a piece of the hidden dim."""
        return SH.is_piece(lp["ffn"]["wk"], self.cfg.d_ff)

    def forward_hidden(self, p: Params, tokens: torch.Tensor, *,
                       state: Optional[RWKVState] = None,
                       lengths: Optional[torch.Tensor] = None,
                       remat: bool = False):
        """tokens (B, S) -> (hidden (B, S, d), the state after them).
        The layers, ``remat`` and sequence parallelism as in
        ``Mamba2LM.forward_hidden``."""
        cfg = self.cfg
        sp = SH.seq_parallel(tokens.shape[1])
        x = rmsnorm(embed_tokens(p, tokens, cfg.vocab_size, sp), p["ln_in"],
                    cfg.norm_eps, gemma_style=True)
        x = SH.constrain(x, "batch", "seq", None)
        outs = []
        for i, lp in enumerate(unstack_layers(p["layers"])):
            st = (None if state is None
                  else (state.mix_x[i], state.ffn_x[i], state.wkv[i]))
            args = (lp, x, st, lengths, sp)
            x, st = (remat_fn(self._layer, *args) if remat
                     else self._layer(*args))
            x = SH.constrain(x, "batch", "seq", None)
            outs.append(st)
        return x, RWKVState(*(torch.stack(t) for t in zip(*outs)))

    def loss(self, p: Params, batch, *, remat: bool = False):
        """The reference's ``loss`` (against ``lm_head``), as
        ``Mamba2LM.loss``."""
        return _lm_loss(self, p, batch, p["lm_head"], remat)

    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return (rmsnorm(x, p["final_norm"], cfg.norm_eps, gemma_style=True)
                @ p["lm_head"]).float()

    def forward(self, p: Params, tokens: torch.Tensor, **kw):
        """tokens (B, S) -> (logits (B, S, V) float32, state)."""
        x, state = self.forward_hidden(p, tokens, **kw)
        return self._head(p, x), state

    # ---------------- serving ----------------
    def init_state(self, batch: int, device="cuda") -> RWKVState:
        cfg = self.cfg
        L, d, H = cfg.num_layers, cfg.d_model, cfg.num_heads
        dk = d // H
        dev = resolve_or_meta(device)
        return RWKVState(
            torch.zeros((L, batch, d), dtype=cfg.torch_dtype, device=dev),
            torch.zeros((L, batch, d), dtype=cfg.torch_dtype, device=dev),
            torch.zeros((L, batch, H, dk, dk), dtype=torch.float32,
                        device=dev))

    def decode_state_specs(self, batch: int, max_seq: int = 0,
                           num_blocks: Optional[int] = None,
                           dp_groups: int = 1) -> RWKVState:
        """The decode-time state as meta tensors (shapes and dtypes); a
        constant state takes no pool, so the pool arguments are unused,
        as in the reference."""
        return self.init_state(batch, device="meta")

    def prefill(self, p: Params, tokens: torch.Tensor, state: RWKVState,
                lengths: torch.Tensor):
        """Right-padded prompts from ``state``: (logits at each row's last
        prompt token (B, V), the state at each row's own length)."""
        x, state = self.forward_hidden(p, tokens, state=state,
                                       lengths=lengths)
        return self._head(p, _last(x, lengths)), state

    def decode_step(self, p: Params, tokens: torch.Tensor, state: RWKVState):
        """tokens (B,) -> (logits (B, V), the advanced state)."""
        cfg = self.cfg
        x = rmsnorm(embed_tokens(p, tokens, cfg.vocab_size), p["ln_in"],
                    cfg.norm_eps, gemma_style=True)
        outs = []
        for i in range(cfg.num_layers):
            lp = layer_params(p["layers"], i)
            h = rmsnorm(x, lp["ln1"], cfg.norm_eps, gemma_style=True)
            y, (last_x, wkv) = R.rwkv6_mix_step(lp["mix"], h, cfg,
                                                state.mix_x[i],
                                                state.wkv[i])
            x = x + y
            h = rmsnorm(x, lp["ln2"], cfg.norm_eps, gemma_style=True)
            x = x + R.rwkv6_ffn(lp["ffn"], h, state.ffn_x[i],
                                split=self._ffn_split(lp))
            outs.append((last_x, h, wkv))
        return self._head(p, x), RWKVState(
            *(torch.stack(t) for t in zip(*outs)))

    # -- constant-state pool glue (serve/arch.ConstantStateStrategy) --
    @property
    def state_elems(self) -> int:
        """Float32 elements of ONE sequence's decode state -- the
        constant-state pool's (exact) block quantum: two shift vectors
        and the per-head wkv matrix state, per layer."""
        cfg = self.cfg
        d, H = cfg.d_model, cfg.num_heads
        dk = d // H
        return cfg.num_layers * (2 * d + H * dk * dk)

    def state_to_rows(self, state: RWKVState) -> torch.Tensor:
        """Flatten the (L, B, ...) state to (B, state_elems) float32 rows:
        the mix shift vectors layer by layer, the ffn ones, the wkv
        states."""
        B = state.mix_x.shape[1]
        parts = [t.movedim(1, 0).reshape(B, -1).float()
                 for t in (state.mix_x, state.ffn_x, state.wkv)]
        return torch.cat(parts, dim=1)

    def rows_to_state(self, rows: torch.Tensor) -> RWKVState:
        """Inverse of ``state_to_rows`` (shift vectors back in the
        compute dtype; the wkv state a view of ``rows``)."""
        cfg = self.cfg
        L, d, H = cfg.num_layers, cfg.d_model, cfg.num_heads
        dk = d // H
        B = rows.shape[0]
        m = rows[:, : L * d].reshape(B, L, d).movedim(0, 1)
        f = rows[:, L * d: 2 * L * d].reshape(B, L, d).movedim(0, 1)
        w = rows[:, 2 * L * d:].reshape(B, L, H, dk, dk).movedim(0, 1)
        return RWKVState(m.to(cfg.torch_dtype), f.to(cfg.torch_dtype), w)
