"""Device selection for the package's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only
when the caller passes ``device="cpu"`` (as the tests do).  Asking for
CUDA on a machine without a usable card raises instead of falling back.
On CUDA, float32 matrix products and convolutions are kept at full
float32 (TF32 off): the ``reduced()`` configurations are float32 and are
held token-identical to the float32 reference.
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
