"""Unified model API: ``build_model(cfg)``.

Dispatches over every family of the reference's ``build_model``: the
decoder transformers (dense and MoE, with GQA/MQA or MLA attention, and
the image-prefixed VLM), the pure SSMs (Mamba2 and RWKV6), the Zamba2
hybrid and the Whisper encoder-decoder.  A family with no model here
raises.

``input_specs`` and ``decode_specs`` give a step's inputs as meta
tensors, the shapes and dtypes of the reference's ``ShapeDtypeStruct``
trees, for the dry run (``launch/dryrun.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
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


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """A training or prefill batch as meta tensors: ``tokens`` and
    ``targets`` (B, S) int32, less the image prefix's tokens, beside a
    VLM's ``image_embeds`` and Whisper's ``frames`` in bfloat16."""
    B, S = shape.global_batch, shape.seq_len
    toks = S
    batch: Dict[str, Any] = {}
    if cfg.family == "audio":
        batch["frames"] = _meta((B, cfg.encoder.num_frames, cfg.d_model),
                                torch.bfloat16)
    if cfg.num_image_tokens:
        toks = S - cfg.num_image_tokens
        batch["image_embeds"] = _meta((B, cfg.num_image_tokens,
                                       cfg.d_model), torch.bfloat16)
    batch["tokens"] = _meta((B, toks), torch.int32)
    batch["targets"] = _meta((B, toks), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape: InputShape, model=None,
                 dp_groups: int = 1) -> Tuple[Any, Any]:
    """(tokens, state) of a serve step as meta tensors: (B,) int32 tokens
    and the model's decode state for a context of ``shape.seq_len``, its
    paged pool exactly covering the batch (``_nb``)."""
    model = model or build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    state = model.decode_state_specs(B, S, num_blocks=_nb(cfg, S, B),
                                     dp_groups=dp_groups)
    return _meta((B,), torch.int32), state


def _nb(cfg: ModelConfig, S: int, B: int) -> int:
    bt = cfg.kv_block_tokens
    return ((S + bt - 1) // bt) * B


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")
