"""Unified model API: ``build_model(cfg)``.

The reference's ``build_model`` dispatches over every family; this
package serves the decoder transformers so far -- dense and MoE, with
GQA/MQA or MLA attention -- and refuses the others (SSM, hybrid, audio,
VLM) loudly until their slices are ported.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM


def build_model(cfg: ModelConfig, *, plain: bool = False) -> DecoderLM:
    """The model for ``cfg``.  ``plain=True`` runs the attention calls on
    their plain PyTorch versions on every device (the kernels' oracle
    path)."""
    if cfg.family not in ("dense", "moe") or cfg.ssm is not None \
            or cfg.encoder is not None:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"only dense and MoE decoders are served by repro_torch")
    return DecoderLM(cfg, plain=plain)
