"""Op-level FLOP / byte / collective accounting of a step as it runs.

Counterpart of ``repro.cost.accounting``.  The reference walks the
optimised HLO of a compiled program; this package compiles nothing ahead
of time, so the program is what the dispatcher sees: ``CostMode`` is a
``TorchDispatchMode`` that bills every aten op of a step as it runs (on
the card, on the CPU or on meta tensors), and the pieces the dispatcher
cannot see bill themselves:

* each port kernel launch (a ctypes call) hands its bill from
  ``cost/kernels.py`` to the active recorder (``kernels/ops.py``);
* each collective of a mesh, real or placeholder, bills its output bytes
  by kind and records the ranks of its group (``launch/mesh.py``).

The paper's rule, as in the reference: bill the bytes an op MOVES, never
the buffer it touches.

=========================================  ================================
aten ops                                   bill (category)
=========================================  ================================
views, aliases, ``empty*`` (``FREE_OPS``)  nothing
``index_select``, ``gather``,              2 x result + index bytes
``embedding``, ``index``                   (``gather``)
``index_put_``, ``index_copy_``,           2 x update + index bytes, never
``scatter_``, ``scatter_add_``,            the tensor written into
``index_add_``                             (``scatter``)
``copy_`` into a view                      source read + slice write
                                           (``dynamic-update-slice``);
                                           into a whole tensor: ``copy``
``mm``, ``bmm``, ``addmm``, ``baddbmm``,   ``2 M N K`` FLOPs
SDPA, convolutions (``flop_registry``)     (``FlopCounterMode``'s own
                                           formulas); reads + write
                                           (``matmul``)
``fill_``, ``zero_``                       the write (``other``)
``clone``, ``_to_copy``                    read + write (``copy``)
anything else                              result writes + operand reads
                                           (``other``)
=========================================  ================================

Elementwise work adds no FLOPs, as in the reference.  An operand is
billed for the elements it can address (a broadcast scalar is one
element, not the shape it is expanded to).  Ops of the ``c10d``
namespace are free: the mesh bills its collectives itself.

**The trap.** Under the generic rule, ``pool.index_put_(idx, rows)``
would bill the whole pool: the overcount that makes paging look several
times dearer than it is.  The indexed-write rule bills the rows.

A kernel's plain version on the CPU is visible op by op, so no bill is
added there: its ops are billed as any others, and also kept under the
kernel's line (``Cost.kernels``), so that a CPU account and a card or
meta account can be compared outside the kernels' lines.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: categories reported in ``Cost.by_op`` (the reference's keys; the port
#: has no fusions, so elementwise passes land in ``other``)
CATEGORY_MATMUL = "matmul"
CATEGORY_DUS = "dynamic-update-slice"
CATEGORY_DSLICE = "dynamic-slice"
CATEGORY_GATHER = "gather"
CATEGORY_SCATTER = "scatter"
CATEGORY_COLLECTIVE = "collective"
CATEGORY_COPY = "copy"
CATEGORY_FUSION = "fusion"
CATEGORY_OTHER = "other"

#: aten ops that move no data: views, aliases, metadata, allocations
FREE_OPS = frozenset({
    "view", "_unsafe_view", "view_as", "_reshape_alias", "reshape",
    "permute", "transpose", "t", "expand", "expand_as", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "alias", "detach", "lift_fresh",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal",
    "unfold", "view_as_real", "view_as_complex", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "resize_",
    "is_same_size", "_has_compatible_shallow_copy_type", "set_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim",
    "is_contiguous", "record_stream", "_nested_tensor_from_mask",
})
#: reads of rows through an index: 2 x result + index bytes
GATHER_OPS = frozenset({"index_select", "gather", "embedding", "index"})
#: in-place indexed writes: 2 x update + index bytes
SCATTER_OPS = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                         "scatter_", "scatter_add_", "index_add_"})
#: ops that only write their result
WRITE_OPS = frozenset({"fill_", "zero_"})
COPY_OPS = frozenset({"clone", "_to_copy", "copy"})


def dominant_category(by_op: Optional[Dict[str, float]]) -> str:
    """Largest-bytes category of a ``Cost.by_op`` dict ('-' when empty)."""
    if not by_op:
        return "-"
    return max(by_op, key=by_op.get)


def _add_into(dst: Dict, src: Dict, times: float = 1.0) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0.0) + v * times


@dataclasses.dataclass
class Cost:
    """Roofline quantities with a per-op-category byte breakdown: the
    reference's fields, and two the port adds -- ``coll_groups``, the
    collective bytes by (kind, axes, the group's global ranks), which the
    roofline's link rates read, and ``kernels``, one line per port kernel
    (``launches``, ``bytes``, ``flops`` and the ``by_op`` it put into the
    totals)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Optional[Dict[str, float]] = None
    by_op: Optional[Dict[str, float]] = None
    coll_groups: Optional[Dict[Tuple, float]] = None
    kernels: Optional[Dict[str, Dict]] = None

    def __post_init__(self):
        if self.coll is None:
            self.coll = {k: 0.0 for k in COLLECTIVE_OPS}
        if self.by_op is None:
            self.by_op = {}
        if self.coll_groups is None:
            self.coll_groups = {}
        if self.kernels is None:
            self.kernels = {}

    def add(self, other: "Cost", times: float = 1.0):
        self.flops += other.flops * times
        self.bytes += other.bytes * times
        for k in COLLECTIVE_OPS:
            self.coll[k] += other.coll[k] * times
        _add_into(self.by_op, other.by_op, times)
        _add_into(self.coll_groups, other.coll_groups, times)
        for name, line in other.kernels.items():
            mine = self._line(name)
            for k in ("launches", "bytes", "flops"):
                mine[k] += line[k] * times
            _add_into(mine["by_op"], line["by_op"], times)

    def add_bytes(self, category: str, n: float):
        self.bytes += n
        self.by_op[category] = self.by_op.get(category, 0.0) + n

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())

    def dominant_op(self) -> str:
        return dominant_category(self.by_op)

    def _line(self, name: str) -> Dict:
        line = self.kernels.get(name)
        if line is None:
            line = self.kernels[name] = {"launches": 0, "bytes": 0.0,
                                         "flops": 0.0, "by_op": {}}
        return line

    def outside_kernels(self) -> Dict[str, float]:
        """``by_op`` less what the kernels' lines put into it (zeros
        dropped)."""
        out = dict(self.by_op)
        for line in self.kernels.values():
            for k, v in line["by_op"].items():
                out[k] = out.get(k, 0.0) - v
        return {k: v for k, v in out.items() if v}


# ---------------------------------------------------------------------------
# the bill of one op
# ---------------------------------------------------------------------------
def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor holds: numel x element size."""
    return t.numel() * t.element_size()


def read_bytes(t: torch.Tensor) -> int:
    """Bytes an operand can address: its elements along every dimension
    of non-zero stride (a broadcast is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _index_bytes(indices) -> int:
    return sum(tensor_bytes(t) for t in _tensors(indices))


def _indexed_elems(self_t: torch.Tensor, indices) -> int:
    """Elements ``self[indices]`` selects (advanced indexing): the
    broadcast index shape times the dimensions left unindexed."""
    idx = [i for i in indices if i is not None]
    if not idx:
        return self_t.numel()
    lead = math.prod(torch.broadcast_shapes(*[i.shape for i in idx]))
    rest = math.prod(s for d, s in enumerate(self_t.shape)
                     if d >= len(indices) or indices[d] is None)
    return lead * rest


def op_bill(func, args, kwargs, out) -> Tuple[float, List[Tuple[str, float]]]:
    """``(flops, [(category, bytes), ...])`` of one dispatched op: the
    rule table of the module docstring."""
    if func.namespace == "c10d":
        return 0.0, []
    name = func._overloadpacket.__name__
    if name in FREE_OPS:
        return 0.0, []
    packet = func._overloadpacket
    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        b = sum(read_bytes(t) for t in _tensors((args, kwargs))) \
            + sum(tensor_bytes(t) for t in _tensors(out))
        return flops, [(CATEGORY_MATMUL, float(b))]
    if name in GATHER_OPS:
        index = args[1] if name == "index" else (
            args[1] if name == "embedding" else args[2])
        return 0.0, [(CATEGORY_GATHER, float(
            2 * sum(tensor_bytes(t) for t in _tensors(out))
            + _index_bytes(index)))]
    if name in SCATTER_OPS:
        dst = args[0]
        es = dst.element_size()
        if name in ("index_put_", "_index_put_impl_"):
            upd = _indexed_elems(dst, args[1]) * es
            idx = _index_bytes(args[1])
        elif name in ("scatter_", "scatter_add_"):
            upd = args[2].numel() * es
            idx = tensor_bytes(args[2])
        else:                          # index_copy_, index_add_
            upd = tensor_bytes(args[3])
            idx = tensor_bytes(args[2])
        return 0.0, [(CATEGORY_SCATTER, float(2 * upd + idx))]
    if name == "copy_":
        dst, src = args[0], args[1]
        cat = CATEGORY_DUS if dst._is_view() else CATEGORY_COPY
        return 0.0, [(cat, float(read_bytes(src) + tensor_bytes(dst)))]
    if name in WRITE_OPS:
        return 0.0, [(CATEGORY_OTHER, float(tensor_bytes(args[0])))]
    b = sum(read_bytes(t) for t in _tensors((args, kwargs))) \
        + sum(tensor_bytes(t) for t in _tensors(out))
    return 0.0, [(CATEGORY_COPY if name in COPY_OPS else CATEGORY_OTHER,
                  float(b))]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
_LOCK = threading.Lock()
#: recorders open in this process (any thread): the kernel wrappers and
#: the mesh look for one only while this is above 0
_OPEN = [0]


def _shape_key(out) -> str:
    ts = _tensors(out)
    if not ts:
        return "()"
    t = ts[0]
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


class CostMode(TorchDispatchMode):
    """Records the bill of every op dispatched while it is entered (in
    this thread, and on the autograd threads it hands its state to) into
    ``self.cost``; ``self.tally`` keeps bytes per (op, result shape), the
    counterpart of the reference's ``attribute``.  With
    ``track_memory`` it also keeps the live bytes of every storage it has
    seen (``memory.LiveBytes``): ``self.memory.peak``."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.cost = Cost()
        self.tally: collections.Counter = collections.Counter()
        self._scopes: List[str] = []
        self.memory = None
        if track_memory:
            from repro_torch.cost.memory import LiveBytes
            self.memory = LiveBytes()

    def __enter__(self):
        with _LOCK:
            _OPEN[0] += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with _LOCK:
                _OPEN[0] -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.memory is not None:
            self.memory.see(_tensors((args, kwargs, out)))
        flops, parts = op_bill(func, args, kwargs, out)
        self._charge(flops, parts, func._overloadpacket.__name__, out)
        return out

    def _charge(self, flops, parts, op, out) -> None:
        cost = self.cost
        cost.flops += flops
        for cat, b in parts:
            cost.add_bytes(cat, b)
            self.tally[(op, _shape_key(out))] += b
        if self._scopes:
            line = cost._line(self._scopes[0])
            line["flops"] += flops
            for cat, b in parts:
                line["bytes"] += b
                line["by_op"][cat] = line["by_op"].get(cat, 0.0) + b

    # -- what the dispatcher cannot see ---------------------------------
    def bill_kernel(self, name: str, parts: Dict[str, float],
                    flops: float) -> None:
        """One launch of a port kernel (on the card or on meta): its
        bytes by category and its FLOPs, into the totals and its line."""
        line = self.cost._line(name)
        line["launches"] += 1
        self.cost.flops += flops
        line["flops"] += flops
        for cat, b in parts.items():
            self.cost.add_bytes(cat, b)
            line["bytes"] += b
            line["by_op"][cat] = line["by_op"].get(cat, 0.0) + b
            self.tally[(name, "kernel")] += b

    @contextlib.contextmanager
    def kernel_scope(self, name: str, launch: bool = False):
        """A kernel wrapper runs inside: the ops it dispatches (its
        checks and copies on every route, its plain version on the CPU,
        ``launch`` counting one launch of ``name``) are billed as usual
        and kept under the kernel's line."""
        if launch:
            self.cost._line(name)["launches"] += 1
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()

    def bill_collective(self, kind: str, nbytes: float, axes: Tuple,
                        ranks: Tuple[int, ...]) -> None:
        """One collective: its output bytes under ``kind`` (one of
        ``COLLECTIVE_OPS``) and under its group."""
        self.cost.coll[kind] += nbytes
        key = (kind, tuple(axes), tuple(ranks))
        self.cost.coll_groups[key] = self.cost.coll_groups.get(key, 0.0) \
            + nbytes
        self.cost.add_bytes(CATEGORY_COLLECTIVE, nbytes)
        self.tally[(kind, "collective")] += nbytes

    def attribute(self, top: int = 20):
        """The ``top`` (op, result shape) byte tallies, largest first."""
        return self.tally.most_common(top)


def active() -> Optional[CostMode]:
    """The innermost ``CostMode`` entered in this thread (or handed to it
    by autograd), or None."""
    if not _OPEN[0]:
        return None
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


def bill_kernel(name: str, bill) -> None:
    """Hand one launch's bill (``kernels.Bill``) to the active recorder,
    if any (``kernels/ops.py`` on the card and on meta)."""
    rec = active()
    if rec is not None:
        rec.bill_kernel(name, bill.parts, bill.flops)


@contextlib.contextmanager
def kernel_scope(name: str, launch: bool = False):
    """A kernel wrapper's call (``launch``: its plain version's, one
    launch on the CPU): its ops are kept under the kernel's line of the
    active recorder, if any."""
    rec = active()
    if rec is None:
        yield
        return
    with rec.kernel_scope(name, launch):
        yield


def bill_collective(kind: str, nbytes: float, axes, ranks) -> None:
    """Hand one collective to the active recorder, if any
    (``launch/mesh.py``)."""
    rec = active()
    if rec is not None:
        rec.bill_collective(kind, nbytes, axes, ranks)


__all__ = ["COLLECTIVE_OPS", "Cost", "CostMode", "active", "bill_kernel",
           "bill_collective", "dominant_category", "kernel_scope", "op_bill",
           "read_bytes", "tensor_bytes"]
