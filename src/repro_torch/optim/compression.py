"""Error-feedback int8 gradient compression for the data-parallel sync.

Counterpart of ``repro.optim.compression``: a gradient is quantized to
int8 with a float32 scale per block of ``BLOCK`` values (the paper's
fixed-size quantum: 8192 float32 values = 32 KB), and the quantization
residual is kept in an error-feedback buffer so the bias cancels across
steps.  ``sync_mean`` is the reference's inside-``shard_map`` function
over an axis group of a ``Mesh``:

  1. add the residual to the local gradient,
  2. quantize to int8 codes + float32 per-block scales,
  3. all-gather the codes and the scales over the axes -- never an int8
     sum, which would overflow and could not carry per-rank scales,
  4. dequantize every rank's codes, average locally (rank order, one
     add after another), keep the new residual.

Plain PyTorch: the reference has no kernel here.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.tree import flatten_with_paths

BLOCK = 8192  # float32 values per scale block (the paper's 32 KB quantum)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: flat float32, length a multiple of BLOCK -> (int8 codes
    (blocks, BLOCK), float32 scales (blocks,))."""
    xb = x.reshape(-1, BLOCK)
    scale = xb.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    t = xb / scale[:, None]
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float().mul_(scale[:, None]).reshape(-1)


def flatten_tree(tree) -> Tuple[torch.Tensor, Any, List]:
    """Tree -> (flat float32 vector, each leaf padded to a multiple of
    BLOCK, the tree's ``unflatten``, [(shape, size)] per leaf), leaves
    in the reference's pytree order."""
    _, flat, unflatten = flatten_with_paths(tree)
    shapes = [(tuple(f.shape), f.numel()) for f in flat]
    vec = torch.zeros(sum(n + (-n) % BLOCK for _, n in shapes),
                      dtype=torch.float32, device=flat[0].device)
    off = 0
    for f, (_, n) in zip(flat, shapes):
        vec[off:off + n].copy_(f.reshape(-1))
        off += n + (-n) % BLOCK
    return vec, unflatten, shapes


def unflatten_tree(vec: torch.Tensor, unflatten, shapes):
    """Inverse of ``flatten_tree`` (float32 views of ``vec``)."""
    out, off = [], 0
    for shp, n in shapes:
        out.append(vec[off:off + n].reshape(shp))
        off += n + ((-n) % BLOCK)
    return unflatten(out)


def sync_mean(vec: torch.Tensor, residual: torch.Tensor, mesh,
              axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean of ``vec`` over ``axes`` of ``mesh``.

    vec/residual: this rank's flat gradient and residual (full length).
    Returns (the mean vector, the new residual)."""
    v = vec + residual
    q, s = quantize(v)
    new_r = dequantize(q, s)
    torch.sub(v, new_r, out=new_r)
    del v
    qg = mesh.all_gather(q, axes)           # (n, blocks, BLOCK) int8
    sg = mesh.all_gather(s, axes)           # (n, blocks) float32
    n = qg.shape[0]
    total = dequantize(qg[0], sg[0])
    for i in range(1, n):
        total.add_(dequantize(qg[i], sg[i]))
    return total.div_(n), new_r
