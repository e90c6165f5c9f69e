"""Convert the reference model's parameters into this package's.

The reference models' ``init`` (``DecoderLM``, the VLM among them,
``Mamba2LM``, ``RWKVLM``, ``Zamba2LM``, ``WhisperModel``) returns a
nested dict of JAX arrays; the caller turns each leaf into a numpy
array (``np.asarray``) and this module maps the tree
onto tensors of the same layout, on ``device``, in the config's dtype --
except the leaves the reference keeps in float32 in every config
(``FLOAT32_LEAVES``).  The trees are identical by construction (same
keys, per-layer weights stacked on leading axes), so the conversion is
leaf by leaf -- and lossless for bfloat16, which goes through float32.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


#: leaves that stay float32 whatever the config's dtype: the MoE router;
#: Mamba2's conv weights and bias, A_log, dt_bias and D; RWKV6's decay
#: base w0 and bonus u.  Whisper's and the VLM's trees add none: every
#: leaf of theirs (``pos``, ``img_proj`` and the encoder's and cross
#: attention's weights among them) takes the config's dtype
FLOAT32_LEAVES = frozenset({"router", "conv_w", "conv_b", "A_log",
                            "dt_bias", "D", "w0", "u"})


def to_torch(leaf: Any, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def convert_params(np_params: Mapping[str, Any], cfg: ModelConfig,
                   device="cuda") -> dict:
    """Map a numpy parameter tree of a reference model onto
    this package's tensors (``cfg.torch_dtype``, or float32 for
    ``FLOAT32_LEAVES``, on ``device``)."""
    dev = resolve_device(device)

    def walk(node, name=None):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        dtype = torch.float32 if name in FLOAT32_LEAVES else cfg.torch_dtype
        return to_torch(node, dtype, dev)

    return walk(np_params)
