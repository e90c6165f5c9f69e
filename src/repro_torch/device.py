"""Device selection for the package's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only
when the caller passes ``device="cpu"`` (as the tests do).  Asking for
CUDA on a machine without a usable card raises instead of falling back.
On CUDA, float32 matrix products and convolutions are kept at full
float32 (TF32 off): the ``reduced()`` configurations are float32 and are
held token-identical to the float32 reference.

``resolve_device`` refuses the meta device; ``resolve_or_meta`` takes it
too, for the models' ``init``/``init_state`` on ``device="meta"``: tensors
without storage, the models' ``param_specs`` and ``decode_state_specs``
(the reference's ``ShapeDtypeStruct`` trees).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_or_meta(device="cuda") -> torch.device:
    """``resolve_device``, or the meta device when asked for it."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)
