"""Unified model API: ``build_model(cfg)``.

The reference's ``build_model`` dispatches over every family; this
package serves the decoder transformers (dense and MoE, with GQA/MQA or
MLA attention), the pure SSMs (Mamba2 and RWKV6) and the Zamba2 hybrid,
and refuses the audio and vision families loudly until their slices are
ported.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM
from repro_torch.models.mamba2_lm import Mamba2LM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.zamba2 import Zamba2LM


def build_model(cfg: ModelConfig, *, plain: bool = False):
    """The model for ``cfg``.  ``plain=True`` runs the attention calls on
    their plain PyTorch versions on every device (the kernels' oracle
    path)."""
    if cfg.family in ("audio", "vlm") or cfg.encoder is not None:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"repro_torch serves decoders, SSMs and the zamba2 hybrid")
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, plain=plain)
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return RWKVLM(cfg, plain=plain)
    if cfg.ssm is not None and cfg.ssm.kind == "mamba2":
        return Mamba2LM(cfg, plain=plain)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) has no model here")
    return DecoderLM(cfg, plain=plain)
