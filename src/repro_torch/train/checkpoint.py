"""Block-based checkpointing: fixed-size blocks + manifest.

Counterpart of ``repro.train.checkpoint``, in its on-disk format: the
paper's allocator discipline applied to model state.  Every tensor is
serialised into fixed-size blocks (4 MiB by default) named by position,
with a JSON manifest as the 'tree' (per-tensor block lists, shapes and
dtypes):

    <dir>/step_<k>/blocks/<tensor_idx>_<block_idx>.bin
    <dir>/step_<k>/manifest.json          (atomic rename last)

Blocks and manifest are written under ``step_<k>.tmp`` and the directory
is renamed when the manifest is on disk, so a crashed writer never
corrupts the previous checkpoint; ``keep_last`` garbage-collects old
steps and orphaned ``.tmp`` directories.

Leaves are named by ``repro_torch.tree.flatten_with_paths``, which gives
the reference's path strings (``opt/.mu/embed``, ``params/layers/...``)
and order, and dtypes by numpy's names.  numpy has no bfloat16, so a
bfloat16 tensor is stored as its raw bytes under the name
``"bfloat16"``, as the reference's ``ml_dtypes`` arrays are.  A
checkpoint written by either package restores in the other.

Under a mesh the files hold whole leaves: ``save(shardings=, mesh=)``
glues each leaf's pieces (the model axis's, ZeRO-1's moment slices) on
every rank and rank 0 writes them, so the files are the reference's
whatever the mesh; ``restore(shardings=, mesh=)`` cuts each leaf to this
rank's piece again: the reference's elastic-restore ``shardings=``,
with placements in place of ``NamedSharding``s.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.launch.shardings import (gather_piece, local_piece,
                                          spec_leaves)
from repro_torch.tree import flatten_with_paths

BLOCK_BYTES = 4 * 1024 * 1024

#: torch dtypes by the numpy name the manifest records
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _host_bytes(leaf):
    """(a uint8 numpy view of the leaf's bytes on the host, shape, dtype
    name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, list(t.shape), _NAMES[t.dtype]
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8), list(arr.shape), str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3,
         block_bytes: int = BLOCK_BYTES, shardings=None, mesh=None) -> str:
    """Serialise a tree of tensors (or numpy arrays); returns the
    checkpoint path.  ``shardings`` (a tree of placements like
    ``tree``'s, with ``mesh``): ``tree`` holds this rank's pieces, which
    every rank glues into whole leaves (a collective), and rank 0
    writes."""
    paths, leaves, _ = flatten_with_paths(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is not None:
        specs = spec_leaves(shardings)
        if len(specs) != len(leaves):
            raise ValueError(f"{len(specs)} placements for {len(leaves)} "
                             f"leaves")
        leaves = [gather_piece(mesh, t, s) for t, s in zip(leaves, specs)]
        if mesh.rank != 0:
            return step_dir
    tmp_dir = step_dir + ".tmp"
    blocks_dir = os.path.join(tmp_dir, "blocks")
    os.makedirs(blocks_dir, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "block_bytes": block_bytes,
                                "tensors": []}
    for ti, (pth, leaf) in enumerate(zip(paths, leaves)):
        raw, shape, dtype = _host_bytes(leaf)
        n_blocks = max(1, (len(raw) + block_bytes - 1) // block_bytes)
        blocks = []
        for bi in range(n_blocks):
            fname = f"{ti:05d}_{bi:05d}.bin"
            with open(os.path.join(blocks_dir, fname), "wb") as f:
                f.write(raw[bi * block_bytes: (bi + 1) * block_bytes])
            blocks.append(fname)
        manifest["tensors"].append({
            "path": pth, "shape": shape, "dtype": dtype,
            "nbytes": len(raw), "blocks": blocks})
    mpath = os.path.join(tmp_dir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)        # atomic commit

    _gc(ckpt_dir, keep_last)
    return step_dir


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    for d in os.listdir(ckpt_dir):      # orphaned tmp dirs from crashes
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _read(step_dir: str, t: Dict[str, Any]) -> torch.Tensor:
    buf = bytearray(t["nbytes"])
    view, off = memoryview(buf), 0
    for b in t["blocks"]:
        with open(os.path.join(step_dir, "blocks", b), "rb") as f:
            off += f.readinto(view[off:])
    if off != t["nbytes"]:
        raise ValueError(f"{t['path']}: {off} bytes in its blocks, the "
                         f"manifest says {t['nbytes']}")
    dtype = DTYPES[t["dtype"]]
    if not buf:
        return torch.empty(t["shape"], dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
        t["shape"])


def restore(ckpt_dir: str, step: int, like_tree, *, shardings=None,
            mesh=None):
    """Rebuild ``like_tree``'s structure from the checkpoint at ``step``:
    each leaf by its path, with the shape and dtype the manifest records,
    on the device of ``like_tree``'s leaf there (the CPU where that leaf
    is not a tensor).  ``shardings`` (a tree of placements like
    ``like_tree``'s, with ``mesh``) cuts each whole leaf to this rank's
    piece (``launch.shardings.local_piece``)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {t["path"]: t for t in manifest["tensors"]}
    paths, leaves, unflatten = flatten_with_paths(like_tree)
    specs = (spec_leaves(shardings) if shardings is not None
             else [None] * len(leaves))
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} placements for {len(leaves)} leaves")
    out = []
    for pth, leaf, spec in zip(paths, leaves, specs):
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        t = _read(step_dir, by_path[pth])
        if spec is not None:
            t = local_piece(mesh, t, spec).contiguous()
        out.append(t.to(dev))
    return unflatten(out)
