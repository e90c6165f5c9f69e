"""Pure Mamba2 (SSD) language model: stacked mamba2 blocks, no attention.

Counterpart of ``repro.models.mamba2_lm.Mamba2LM``.  Decode state is
O(1) per layer -- a conv window plus the SSD matrix state -- so serving
uses the constant-state pool discipline (one fixed-size Arena block per
sequence, zero growth): ``ConstantStateStrategy`` in ``serve/arch.py``.
Prefill masks right padding exactly (``mamba2_fwd(lengths=...)``), so a
padded batched prefill is token-identical to per-sequence prefill.

As in ``models/lm.py``, parameters are a dict of tensors with the
reference's tree (per-layer weights stacked on a leading L axis), a
Python loop over layers replaces ``lax.scan``, and every entry point
runs eagerly.  The model runs no kernel of ``kernels/``: the reference
has no Pallas kernel for the SSD scan.

On a mesh's model axis (the train and forward steps; the serve and
prefill steps refuse a ``Mamba2State``, as the reference's
``state_shardings`` does) the embedding is vocab-parallel and tied to
the head (``shardings.vocab_lookup``, ``chunked_lm_loss(vocab_parallel=
True)``), the mixers are split by heads (``models/mamba2.py``) and,
under sequence parallelism, the residual stream is this rank's sequence
piece.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_or_meta
from repro_torch.launch import shardings as SH
from repro_torch.models import mamba2 as M2
from repro_torch.models.common import (Params, chunked_lm_loss,
                                       embed_tokens, rmsnorm, trunc_normal)
from repro_torch.models.common import (EMBED_AXES, Stacked, meta_specs,
                                       seeded_generator)
from repro_torch.models.common import remat as remat_fn
from repro_torch.models.lm import _init_stacked, layer_params, unstack_layers


@dataclasses.dataclass
class Mamba2State:
    """Decode state: (L,B,W-1,cd) conv windows + (L,B,H,P,N) SSD state,
    both float32."""
    conv: torch.Tensor
    ssd: torch.Tensor


def _lm_loss(model, p: Params, batch, head_w: torch.Tensor, remat: bool):
    """The state families' ``loss``: final norm, ``chunked_lm_loss``
    against ``head_w`` (vocab-parallel where it holds a vocabulary
    piece; a hidden in sequence pieces gathered first), the mean over
    unmasked targets."""
    cfg = model.cfg
    dev = p["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = torch.as_tensor(batch["targets"], device=dev)
    x = model.forward_hidden(p, tokens, remat=remat)[0]
    xn = rmsnorm(x, p["final_norm"], cfg.norm_eps, gemma_style=True)
    if SH.is_piece(xn, targets.shape[1], dim=1):   # a sequence piece
        xn = SH.seq_gather(xn)
    nll, cnt = chunked_lm_loss(
        xn, head_w, targets,
        vocab_parallel=SH.is_piece(head_w, cfg.vocab_size, dim=1))
    loss = nll / cnt.clamp(min=1.0)
    return loss, {"nll": loss}


def _last(t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """t (B, S, ...) at each row's last valid position (B, ...)."""
    idx = (lengths.long() - 1).clamp(min=0)
    return t[torch.arange(t.shape[0], device=t.device), idx]


class Mamba2LM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False):
        assert cfg.ssm is not None and cfg.ssm.kind == "mamba2"
        self.cfg = cfg          # no kernel on this path: ``plain`` is moot

    def param_specs(self):
        """(the parameter tree as meta tensors, its logical-axes tree):
        the reference's ``param_specs``, leaf for leaf, without
        allocating."""
        return meta_specs(self, {**EMBED_AXES, "layers": Stacked({"mamba": M2.MAMBA2_AXES})})

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (the reference's tree and scales; the numbers differ
        from JAX's -- tests convert the reference's parameters)."""
        cfg = self.cfg
        dev = resolve_or_meta(device)
        g = seeded_generator(dev, seed)
        dt, d = cfg.torch_dtype, cfg.d_model
        p: Params = {
            "embed": trunc_normal((cfg.vocab_size, d), 1.0, dt, dev, g),
            "final_norm": torch.zeros(d, dtype=dt, device=dev)}
        p["layers"] = _init_stacked(
            lambda: {"mamba": M2.init_mamba2(g, cfg, dev),
                     "ln": torch.zeros(d, dtype=dt, device=dev)},
            cfg.num_layers)
        return p

    # ---------------- forward ----------------
    def _head(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return (rmsnorm(x, p["final_norm"], cfg.norm_eps, gemma_style=True)
                @ p["embed"].T).float()

    def _layer(self, lp: Params, x: torch.Tensor, cs=None, ss=None,
               lengths: Optional[torch.Tensor] = None,
               seq_parallel: bool = False):
        cfg = self.cfg
        h = rmsnorm(x, lp["ln"], cfg.norm_eps, gemma_style=True)
        y, (cs, ss) = M2.mamba2_fwd(lp["mamba"], h, cfg, cs, ss,
                                    lengths=lengths,
                                    seq_parallel=seq_parallel)
        return x + y, (cs, ss)

    def forward_hidden(self, p: Params, tokens: torch.Tensor, *,
                       state: Optional[Mamba2State] = None,
                       lengths: Optional[torch.Tensor] = None,
                       remat: bool = False):
        """tokens (B, S) -> (hidden (B, S, d), the state after them).
        The layers come from ``unstack_layers``; ``remat=True``
        recomputes each layer in the backward pass, as the reference's
        ``jax.checkpoint(body)``.  On a model axis whose rules map
        ``seq`` onto it and that divides S, the residual stream and the
        hidden are this rank's sequence piece (B, S / tp, d)."""
        sp = SH.seq_parallel(tokens.shape[1])
        x = SH.constrain(embed_tokens(p, tokens, self.cfg.vocab_size, sp),
                         "batch", "seq", None)
        convs, ssds = [], []
        for i, lp in enumerate(unstack_layers(p["layers"])):
            cs = ss = None
            if state is not None:
                cs, ss = state.conv[i], state.ssd[i]
            args = (lp, x, cs, ss, lengths, sp)
            x, (cs, ss) = (remat_fn(self._layer, *args) if remat
                           else self._layer(*args))
            x = SH.constrain(x, "batch", "seq", None)
            convs.append(cs)
            ssds.append(ss)
        return x, Mamba2State(torch.stack(convs), torch.stack(ssds))

    def loss(self, p: Params, batch, *, remat: bool = False):
        """The reference's ``loss``: mean next-token NLL of batch
        ``{"tokens", "targets"}`` (targets -1 masked) -> (loss,
        {"nll": loss})."""
        return _lm_loss(self, p, batch, p["embed"].T, remat)

    def forward(self, p: Params, tokens: torch.Tensor, **kw):
        """tokens (B, S) -> (logits (B, S, V) float32, state)."""
        x, state = self.forward_hidden(p, tokens, **kw)
        return self._head(p, x), state

    # ---------------- serving ----------------
    def init_state(self, batch: int, device="cuda") -> Mamba2State:
        cfg = self.cfg
        d_inner, H, P, N, W = M2._dims(cfg)
        L = cfg.num_layers
        dev = resolve_or_meta(device)
        return Mamba2State(
            torch.zeros((L, batch, W - 1, d_inner + 2 * N),
                        dtype=torch.float32, device=dev),
            torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                        device=dev))

    def decode_state_specs(self, batch: int, max_seq: int = 0,
                           num_blocks: Optional[int] = None,
                           dp_groups: int = 1) -> Mamba2State:
        """The decode-time state as meta tensors (shapes and dtypes); a
        constant state takes no pool, so the pool arguments are unused,
        as in the reference."""
        return self.init_state(batch, device="meta")

    def prefill(self, p: Params, tokens: torch.Tensor, state: Mamba2State,
                lengths: torch.Tensor):
        """Right-padded prompts from ``state``: (logits at each row's last
        prompt token (B, V), the state at each row's own length)."""
        x, state = self.forward_hidden(p, tokens, state=state,
                                       lengths=lengths)
        return self._head(p, _last(x, lengths)), state

    def decode_step(self, p: Params, tokens: torch.Tensor,
                    state: Mamba2State):
        """tokens (B,) -> (logits (B, V), the advanced state)."""
        cfg = self.cfg
        x = embed_tokens(p, tokens, cfg.vocab_size)
        convs, ssds = [], []
        for i in range(cfg.num_layers):
            lp = layer_params(p["layers"], i)
            h = rmsnorm(x, lp["ln"], cfg.norm_eps, gemma_style=True)
            y, (cs, ss) = M2.mamba2_step(lp["mamba"], h, cfg, state.conv[i],
                                         state.ssd[i])
            x = x + y
            convs.append(cs)
            ssds.append(ss)
        return self._head(p, x), Mamba2State(torch.stack(convs),
                                             torch.stack(ssds))

    # -- constant-state pool glue (serve/arch.ConstantStateStrategy) --
    @property
    def state_elems(self) -> int:
        """Float32 elements of ONE sequence's recurrent state -- the
        constant-state pool's (exact) block quantum."""
        d_inner, H, P, N, W = M2._dims(self.cfg)
        return self.cfg.num_layers * ((W - 1) * (d_inner + 2 * N)
                                      + H * P * N)

    def state_to_rows(self, state: Mamba2State) -> torch.Tensor:
        """Flatten the (L, B, ...) state to (B, state_elems) rows: each
        row's conv windows layer by layer, then its SSD states."""
        B = state.conv.shape[1]
        c = state.conv.movedim(1, 0).reshape(B, -1)
        s = state.ssd.movedim(1, 0).reshape(B, -1)
        return torch.cat([c, s], dim=1).float()

    def rows_to_state(self, rows: torch.Tensor) -> Mamba2State:
        """Inverse of ``state_to_rows`` (views of ``rows``)."""
        d_inner, H, P, N, W = M2._dims(self.cfg)
        L = self.cfg.num_layers
        B = rows.shape[0]
        cd = d_inner + 2 * N
        csize = L * (W - 1) * cd
        conv = rows[:, :csize].reshape(B, L, W - 1, cd).movedim(0, 1)
        ssd = rows[:, csize:].reshape(B, L, H, P, N).movedim(0, 1)
        return Mamba2State(conv, ssd)
