"""Unified model API: ``build_model(cfg)``.

Dispatches over every family of the reference's ``build_model``: the
decoder transformers (dense and MoE, with GQA/MQA or MLA attention, and
the image-prefixed VLM), the pure SSMs (Mamba2 and RWKV6), the Zamba2
hybrid and the Whisper encoder-decoder.  A family with no model here
raises.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM
from repro_torch.models.mamba2_lm import Mamba2LM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba2 import Zamba2LM


def build_model(cfg: ModelConfig, *, max_positions: int = 4096,
                plain: bool = False):
    """The model for ``cfg``.  ``max_positions`` sizes Whisper's learned
    decoder positions.  ``plain=True`` runs the attention calls on their
    plain PyTorch versions on every device (the kernels' oracle path)."""
    if cfg.family == "audio":
        return WhisperModel(cfg, max_positions=max_positions, plain=plain)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, plain=plain)
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return RWKVLM(cfg, plain=plain)
    if cfg.ssm is not None and cfg.ssm.kind == "mamba2":
        return Mamba2LM(cfg, plain=plain)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) has no model here")
    return DecoderLM(cfg, plain=plain)
