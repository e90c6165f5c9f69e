"""The hardware model of one NVIDIA H100 SXM, and roofline terms.

    bound(nbytes, flops, dtype)  -- the least time the card could take for
                                    a function: bytes over the HBM rate or
                                    operations over the peak for their
                                    type, whichever is larger (ms)
    Roofline                     -- compute and memory terms of a step
                                    from its FLOP and byte counts, the
                                    bottleneck, the bound and the model
                                    FLOPs' share of it
    model_flops_for(cfg, shape)  -- 6 N D (train), 2 N D (prefill), 2 N
                                    per token (decode)

Constants from NVIDIA's H100 SXM datasheet (dense rates, no sparsity, at
the card's full 700 W power limit; a card set lower runs slower, so a
reading names its card and limit beside it): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3.

The counterpart of the reference's ``roofline.py``, whose constants are
another chip's.  What it cannot have yet:

* ``collective_bytes`` and ``analyze`` parse the optimised XLA HLO of a
  compiled dry run, and ``Roofline.dominant_mem_op`` reads the
  reference's HLO cost accounting (``repro.cost``); a per-launch
  account of the bytes each port kernel moves is ROADMAP item 5.
* The collective term and a link rate for it (NVLink) wait for
  sharding, ROADMAP item 2: on one card ``t_collective`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
F32_FLOPS = 67e12            # float32, CUDA cores, per card
HBM_BW = 3.35e12             # bytes/s, HBM3, per card


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """``(ms, "bytes" | "operations")``: the larger of ``nbytes`` over
    ``HBM_BW`` and ``flops`` over the peak of ``dtype`` (bf16's for
    bfloat16, float32's for anything else)."""
    peak = PEAK_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one (arch x shape) step on ``chips`` cards, in
    seconds, from per-card FLOP and byte counts: the reference's fields
    but those its HLO accounting fills."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    peak_memory_per_chip: float
    model_flops: float           # 6*N*D (or 6*N_active*D)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        """0 until a link rate exists (ROADMAP item 2); a step that moves
        collective bytes on one card is refused."""
        if self.coll_bytes_per_chip:
            raise ValueError("collective bytes need a link rate: sharding "
                             "is not ported (ROADMAP item 2)")
        return 0.0

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time (the score)."""
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS
        return t_useful / max(self.t_bound, 1e-30)

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / counted FLOPs -- the remat/redundancy waste
        detector."""
        return self.model_flops / max(self.flops_per_chip * self.chips, 1e-30)

    def row(self) -> Dict:
        """The reference's row under its key names, without the keys
        that its HLO accounting fills (``coll_by_kind_gb``,
        ``mem_by_op_gb``, ``dominant_mem_op``, ``xla_raw``)."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops_per_chip": self.flops_per_chip / 1e9,
            "hbm_gb_per_chip": self.bytes_per_chip / 1e9,
            "coll_gb_per_chip": self.coll_bytes_per_chip / 1e9,
            "peak_mem_gb_per_chip": self.peak_memory_per_chip / 1e9,
            "model_gflops_global": self.model_flops / 1e9,
            "useful_flops_ratio": self.flops_utilization,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """6*N*D for training; 2*N*D forward-only; decode: 2*N_active per token
    (+ attention KV term folded into the step's own accounting, not the
    model number)."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if shape.name.startswith("prefill"):
            return 2.0 * n_active * B * S
        return 6.0 * n_active * B * S
    # decode: one token per sequence
    return 2.0 * n_active * B
