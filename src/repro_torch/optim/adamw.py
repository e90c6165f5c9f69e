"""AdamW with global-norm clipping and a cosine schedule.

Counterpart of ``repro.optim.adamw``, with its arithmetic: float32
moments, the update computed in float32 from the gradient scaled by
``min(1, clip_norm / global_norm)`` and rounded to the parameter's
dtype, bias corrections and the learning rate from the float32 step.
Each leaf's update is one ``kernels.ops.adamw_update``: on the card one
pass of a hand-written kernel (``kernels/csrc/adamw.cu``, the fusion
XLA makes of the reference's ``upd``), on the CPU its plain version.

Differences in form: the parameters and moments are the same nested
dicts of tensors, updated IN PLACE (the reference returns new trees);
``AdamWState.step`` is a 0-d int32 tensor on the parameters' device,
incremented in place, so the state a call returns holds the same step
tensor (a captured train step reads and bumps it at every replay); the
schedule, the norm and the clip scale stay 0-d device tensors, so a
step never waits for the host.  ``apply_updates(gnorm=)`` takes the
global norm from its caller: ZeRO-1 (``launch/steps.py``) updates each
rank's slices of the parameters and moments, while the clip norm comes
from the whole averaged gradient, never from a slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # tree like params, float32
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` at
    ``total_steps``; float32 0-d."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(1, cfg.warmup_steps)
    prog = ((step - cfg.warmup_steps)
            / max(1, cfg.total_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> AdamWState:
    """Zero float32 moments like ``params`` and step 0, on the
    parameters' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.clone, zeros))


#: elements a row of ``sum_squares``'s reduction holds
_NORM_RUN = 1 << 10


def sum_squares(t: torch.Tensor) -> torch.Tensor:
    """The sum of the squares of ``t``'s elements, in float32, as the
    reference sums them (``jnp.sum(jnp.square(l.astype(f32)))``).  One
    fused ``vector_norm`` pass reads ``t`` as rows of ``_NORM_RUN``
    elements (a row's norm each, the squares never stored), then the
    rows' squares and the tail's are summed.  ``vector_norm`` over a
    whole large float32 leaf accumulates on the CPU with relative errors
    near 4e-5 (an 860k-element leaf), outside the 1e-5 the train steps
    are held to; over rows of 2**10 they stay near 1e-7."""
    flat = t.reshape(-1)
    m = flat.numel() - flat.numel() % _NORM_RUN
    sq = torch.linalg.vector_norm(flat[:m].view(-1, _NORM_RUN), dim=1,
                                  dtype=torch.float32).square().sum()
    if m < flat.numel():
        sq = sq + torch.linalg.vector_norm(flat[m:],
                                           dtype=torch.float32).square()
    return sq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.stack([sum_squares(l) for l in tree_leaves(tree)]
                       ).sum().sqrt()


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                  gnorm: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``params``, the moments of ``state`` and its step
    (+ 1) are updated in place; returns (params, the state, holding the
    same tensors, {"grad_norm", "lr"}).  The clip norm is
    ``global_norm(grads)`` unless ``gnorm`` gives it.  Each leaf goes to
    ``ops.adamw_update``, which takes CPU tensors to the plain version,
    CUDA tensors to the kernel, and raises on anything else."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (cfg.clip_norm / gnorm.clamp(min=1e-12)).clamp(max=1.0)
    step = state.step.add_(1)
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        ops.adamw_update(p, g, m, v, scale, lr, b1c, b2c, cfg)
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
