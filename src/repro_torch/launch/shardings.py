"""Logical-axis sharding rules, as data.

Counterpart of ``repro.launch.shardings``: the models' logical axes
(``param_specs``) map onto mesh axes by one rule set.  A placement is a
plain tuple in ``PartitionSpec`` order -- one entry per dimension:
``None`` (replicated), a mesh axis name, or a tuple of names (the
dimension split over those axes, row-major) -- so a test compares it
with the reference's ``NamedSharding.spec`` entry for entry.  There is
no DTensor here (it needs the default process group): a rank holds the
piece of each tensor its coordinates select (``local_piece``) and puts
the whole back together with the mesh's collectives
(``gather_piece``).

Rules (logical axis -> mesh axes):
    batch  -> ("pod", "data")   activations' batch dim
    heads  -> "model"           attn heads / ffn hidden / expert hidden
    vocab  -> "model"
    embed  -> None (replicated)
    expert -> None
    seq    -> "model"           sequence parallelism
    ctx    -> "model"           context parallelism

The reference's ``constrain`` (a sharding constraint on an activation)
has no meaning in explicit SPMD over a ``model`` axis of 1, where every
activation a rank holds is its own rows: it comes with the model-axis
slice (ROADMAP.md queue 1, item 2), as do the ``seq``/``ctx`` rules'
effects.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import torch

_state = threading.local()

DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "heads": "model",
    "attn_heads": "model",  # set to None per-arch when heads % tp != 0
    "vocab": "model",
    "embed": None,
    "expert": None,
    "layers": None,
    "seq": "model",
    "ctx": "model",
}


def _current():
    return getattr(_state, "ctx", None)


def _filter(rules: Dict[str, Any], axes) -> Dict[str, Any]:
    """Drop mesh axes the mesh lacks (a single-pod mesh has no pod)."""
    def filt(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in axes)
            return kept if kept else None
        return v if v in axes else None
    return {k: filt(v) for k, v in rules.items()}


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, Any]] = None):
    """Make ``mesh`` and the rule set (the defaults updated by
    ``rules``) this thread's active ones -- each rank thread has its
    own."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    merged = _filter(merged, set(mesh.axis_names))
    prev = _current()
    _state.ctx = (mesh, merged)
    try:
        yield
    finally:
        _state.ctx = prev


def normalize(spec) -> Tuple:
    """A placement in ``PartitionSpec``'s own form: an entry naming one
    axis as a 1-tuple becomes that name, an empty one None."""
    def one(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(one(e) for e in spec)


def spec_for(logical: Tuple[Optional[str], ...],
             rules: Optional[Dict[str, Any]] = None) -> Tuple:
    """The placement of a tensor with these logical axes."""
    ctx = _current()
    if rules is None:
        rules = ctx[1] if ctx else DEFAULT_RULES
    return normalize(rules.get(a) if a else None for a in logical)


def active_mesh():
    ctx = _current()
    return ctx[0] if ctx else None


def tp_size() -> int:
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def use_ctx_parallel(num_heads: int) -> bool:
    """True when per-head sharding over 'model' is impossible and
    attention should be context-parallel instead."""
    tp = tp_size()
    return tp > 1 and num_heads % tp != 0


def _is_axes(t) -> bool:
    return isinstance(t, tuple)


def map_axes(fn, tree):
    """``fn`` over every leaf of a tree whose leaves are tuples (axes or
    placements) and whose nodes are dicts."""
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_leaves(tree) -> list:
    """The placements of a tree of placements (dicts and NamedTuples of
    ``PartitionSpec`` tuples), in ``repro_torch.tree``'s leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [s for f in tree._fields for s in spec_leaves(getattr(tree,
                                                                     f))]
    return [tree]


def param_shardings(axes_tree, mesh,
                    rules: Optional[Dict[str, Any]] = None):
    """A logical-axes tree (from ``param_specs``) -> a placement per
    leaf."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    axes = set(mesh.axis_names)

    def one(t):
        spec = []
        for a in t:
            v = merged.get(a) if a else None
            if isinstance(v, tuple):
                v = tuple(x for x in v if x in axes) or None
            elif v is not None and v not in axes:
                v = None
            spec.append(v)
        return normalize(spec)

    return map_axes(one, axes_tree)


# -- a rank's piece of a placed tensor ------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_piece(mesh, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """The view of ``t`` (the whole tensor) that this rank holds under
    placement ``spec``: each split dimension cut into equal pieces,
    this rank's by its coordinates along the entry's axes."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        k = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(axes) * k, k)
    return t


def gather_piece(mesh, piece: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """The whole tensor from every rank's ``local_piece`` under
    ``spec`` (one all-gather per split dimension)."""
    for dim in reversed(range(len(spec))):
        axes = _entry_axes(spec[dim])
        if not axes or mesh.axis_size(axes) == 1:
            continue
        parts = mesh.all_gather(piece, axes)
        piece = torch.cat(list(parts.unbind(0)), dim=dim)
    return piece


def is_split(mesh, spec: Tuple) -> bool:
    """Whether ``spec`` cuts anything on ``mesh``."""
    return any(mesh.axis_size(_entry_axes(e)) > 1 for e in spec
               if _entry_axes(e))
