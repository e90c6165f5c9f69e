"""Assigned input shapes and the (arch x shape) cell matrix.

A copy of the reference's ``configs/shapes.py`` on this package's
``ARCH_IDS``.  LM shapes are seq_len x global_batch.  ``decode_*``/
``long_*`` are a serve step (one new token against a KV cache of
seq_len); the others a train step.  ``long_500k`` requires
sub-quadratic sequence mixing and therefore runs only for the SSM/hybrid
archs.  No cell fits one card at these sizes; they wait for sharding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ARCH_IDS


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "train"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# prefill_32k is "inference-prefill": forward-only over the full sequence
# and the prefill KV write (no backward).

_SUBQUADRATIC = {"rwkv6_7b", "zamba2_2p7b"}


def cell_is_runnable(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in _SUBQUADRATIC:
        return False, ("N/A-by-spec: full-attention arch; long_500k needs "
                       "sub-quadratic sequence mixing (DESIGN.md §5)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_is_runnable(arch, shape)
            out.append((arch, shape, ok, why))
    return out
