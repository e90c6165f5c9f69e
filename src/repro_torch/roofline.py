"""The hardware model of one NVIDIA H100 SXM, and roofline terms.

    bound(nbytes, flops, dtype)  -- the least time the card could take for
                                    a function: bytes over the HBM rate or
                                    operations over the peak for their
                                    type, whichever is larger (ms)
    Roofline                     -- compute, memory and collective terms
                                    of a step from its FLOP, byte and
                                    collective counts, the bottleneck, the
                                    bound and the model FLOPs' share of it
    analyze(cost, peak, ...)     -- a ``Roofline`` from a step's account
                                    (``repro_torch.cost``)
    collective_bytes(cost)       -- the account's collective bytes by kind
    model_flops_for(cfg, shape)  -- 6 N D (train), 2 N D (prefill), 2 N
                                    per token (decode)

Constants from NVIDIA's H100 SXM datasheet (dense rates, no sparsity, at
the card's full 700 W power limit; a card set lower runs slower, so a
reading names its card and limit beside it): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3.
Link rates, also datasheet rates and not readings: NVLink 4 on an HGX
H100 8-GPU board, 900 GB/s a card both ways, 450 GB/s a direction
(NVIDIA H100 datasheet); across boards one ConnectX-7 400 Gb/s NIC a
card, 50 GB/s a direction (NVIDIA DGX H100 user guide: eight 400 Gb/s
compute ports, one a GPU).

The counterpart of the reference's ``roofline.py``, whose constants are
another chip's.  Its HLO half reads a compiled module; this one reads
the port's own account of a step (``repro_torch.cost``, recorded as the
step runs), so ``hlo_gflops_per_chip`` in a row is the account's FLOPs
and ``xla_raw`` is ``FlopCounterMode``'s total (``raw``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
F32_FLOPS = 67e12            # float32, CUDA cores, per card
HBM_BW = 3.35e12             # bytes/s, HBM3, per card
NVLINK_BW = 450e9            # bytes/s a direction a card, NVLink 4 (HGX)
NET_BW = 50e9                # bytes/s a direction a card, a 400 Gb/s NIC
#: cards on one NVLink domain: an 8-GPU HGX board
NODE_CARDS = 8


def link_rate(ranks) -> float:
    """The link rate of a collective over the global ``ranks``: NVLink
    when they share one board (``rank // NODE_CARDS``), the network
    otherwise.  Ranks are numbered row-major over the mesh, so on 16 x 16
    every production group crosses boards; NVLink applies to meshes of
    up to ``NODE_CARDS`` cards."""
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) <= 1 \
        else NET_BW


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
    seconds, from per-card FLOP, byte and collective counts: the
    reference's fields, and ``coll_groups`` (collective bytes by kind,
    axes and the group's global ranks) for the link rates."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    peak_memory_per_chip: float
    model_flops: float           # 6*N*D (or 6*N_active*D)
    coll_by_kind: Optional[Dict[str, float]] = None
    bytes_by_op: Optional[Dict[str, float]] = None
    xla_raw: Optional[Dict[str, float]] = None
    coll_groups: Optional[Dict[Tuple, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        """Each group's bytes over its link rate (``link_rate``); bytes
        whose group is not known go at the network rate."""
        if not self.coll_groups:
            return self.coll_bytes_per_chip / NET_BW
        return sum(b / link_rate(ranks)
                   for (_, _, ranks), b in self.coll_groups.items())

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

    @property
    def dominant_mem_op(self) -> str:
        from repro_torch.cost.accounting import dominant_category
        return dominant_category(self.bytes_by_op)

    def row(self) -> Dict:
        """The reference's row under its key names; the port's
        ``hlo_gflops_per_chip`` is the account's FLOPs, its ``xla_raw``
        ``FlopCounterMode``'s."""
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
            "coll_by_kind_gb": {k: v / 1e9 for k, v in
                                (self.coll_by_kind or {}).items()},
            "mem_by_op_gb": {k: v / 1e9 for k, v in
                             sorted((self.bytes_by_op or {}).items(),
                                    key=lambda kv: -kv[1])},
            "dominant_mem_op": self.dominant_mem_op,
            "xla_raw": self.xla_raw or {},
        }


def collective_bytes(cost) -> Dict[str, float]:
    """A step's collective output bytes by kind, from its account's
    ``coll`` (every kind, zeros included), and their ``total``."""
    out = dict(cost.coll)
    out["total"] = sum(cost.coll.values())
    return out


def analyze(cost, peak: float, *, arch: str, shape: str, mesh_desc: str,
            chips: int, model_flops: float,
            raw: Optional[Dict[str, float]] = None) -> Roofline:
    """The roofline of one rank's step from its account (``cost``, a
    ``repro_torch.cost.Cost``) and its peak of live bytes: the per-card
    FLOPs, bytes and collective bytes are the account's, ``raw`` (the
    ``FlopCounterMode`` total, ``cost.counter.raw``) is kept beside them
    in the row's ``xla_raw``."""
    rl = Roofline(arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
                  flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
                  coll_bytes_per_chip=cost.coll_total,
                  peak_memory_per_chip=float(peak), model_flops=model_flops)
    rl.coll_by_kind = {k: v for k, v in cost.coll.items() if v}
    rl.bytes_by_op = {k: v for k, v in cost.by_op.items() if v}
    rl.coll_groups = dict(cost.coll_groups)
    rl.xla_raw = dict(raw or {})
    return rl


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
