"""Logical-axis sharding rules, as data, and the model axis's collectives.

Counterpart of ``repro.launch.shardings``: the models' logical axes
(``param_specs``) map onto mesh axes by one rule set.  A placement is a
plain tuple in ``PartitionSpec`` order -- one entry per dimension:
``None`` (replicated), a mesh axis name, or a tuple of names (the
dimension split over those axes, row-major) -- so a test compares it
with the reference's ``NamedSharding.spec`` entry for entry.  One entry
has no ``PartitionSpec`` form: ``Shared(axis, n)``, a dimension of ``n``
pieces (KV heads) read by more ranks than there are pieces, each rank
holding the piece its query heads read.  Another neither:
``Packed(axis, parts)``, a dimension that packs parts of fixed widths
(Mamba2's ``in_proj`` columns ``[z | x | B | C | dt]``), each cut over
``axis`` or held whole, a rank's piece their pieces concatenated.
There is no DTensor here (it
needs the default process group): a rank holds the piece of each tensor
its coordinates select (``local_piece``) and puts the whole back
together with the mesh's collectives (``gather_piece``).

Rules (logical axis -> mesh axes):
    batch  -> ("pod", "data")   activations' batch dim
    heads  -> "model"           attn heads / ffn hidden / expert hidden
    vocab  -> "model"
    embed  -> None (replicated)
    expert -> None
    seq    -> "model"           sequence parallelism (the train and
                                forward steps; the serve steps set it to
                                None)
    frames -> as seq            an encoder's sequence (Whisper's audio
                                frames), split where ``seq`` is; its
                                global size is declared apart
    ctx    -> "model"           context parallelism

Explicit Megatron over the ``model`` axis.  A rank holds column pieces
of the q/k/v, MLP-in and head products and row pieces of the products
after them; the sums that GSPMD inserts in the reference are written
out here: ``row_parallel`` (a row piece's product, the ranks' partial
sums added in float32 and rounded once), ``partial_sum``,
``vocab_lookup`` (the vocab-parallel embedding), ``gather_model`` (an
all-gather of pieces), ``model_all_to_all`` and ``model_sum_squares``
(the sum of squares of a norm over a width split by heads: the state
families' mixers end in one RMSNorm over every head).  Under sequence
parallelism (``seq_parallel``) the residual stream holds this rank's
piece of the sequence: ``seq_gather`` (an all-gather) brings the whole
sequence to a column-parallel product, and the row-parallel sum is
reduce-scattered back to the piece (``row_parallel(seq_parallel=True)``).

Each collective is a ``torch.autograd.Function`` whose backward pass is
its adjoint: an all-reduce's is an all-reduce, an all-gather's a
reduce-scatter and the reverse, an all-to-all's the same exchange.  That
is the rule for a loss that is a SUM of the ranks' shares (the train
step gives each model rank ``1 / tp`` of a loss they all hold whole), so
a rank's gradient of any tensor it holds is its share of that tensor's
gradient, and a parameter's gradient is the sum of the shares of the
ranks that hold the same piece (``launch/steps.py``, ``_sum_grads``).
Megatron's f/g pair (identity forward with an all-reduce backward on
the input of a column-parallel product, an all-reduce forward with an
identity backward after the row-parallel one) is the same algebra for a
loss every rank holds whole; the shares let one rule serve every layout
-- heads split or context-parallel, sequence pieces or not, experts
split or exchanged -- without asking which replicated weights see
partial gradients.  Sums in the backward pass are float32 too, rounded
once.  Autograd over thread ranks that share a card raises: they share
its autograd device thread, so a collective in one rank's backward pass
could wait on a peer queued behind it (run such ranks as processes,
``launch.mesh.spawn_ranks``).  ``constrain`` checks that an activation
has the local shape its placement gives it (the reference's sharding
constraint, which in explicit SPMD is a check, not a request).
"""

from __future__ import annotations

import contextlib
import dataclasses
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


#: logical axes placed by another axis's rule: an encoder's frames go
#: where the decoder's sequence goes (the reference names both "seq"),
#: with a global size of their own for ``constrain``
_RULE_OF = {"frames": "seq"}


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
def use_rules(mesh, rules: Optional[Dict[str, Any]] = None,
              sizes: Optional[Dict[str, int]] = None):
    """Make ``mesh`` and the rule set (the defaults updated by
    ``rules``) this thread's active ones -- each rank thread has its
    own.  ``sizes`` gives the global size of logical axes (``batch``,
    ``vocab``, ``attn_heads``) for ``constrain`` to check against."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    merged = _filter(merged, set(mesh.axis_names))
    prev = _current()
    _state.ctx = (mesh, merged, dict(sizes or {}))
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules():
    """This thread's active (mesh, rules, sizes), or None."""
    return _current()


@contextlib.contextmanager
def restore_rules(ctx):
    """Make ``ctx`` (a ``current_rules()`` value) this thread's active
    rules for the block: the context a recomputation in the backward
    pass runs under, on whatever thread autograd runs it (on the card,
    its device thread, where no ``use_rules`` was entered)."""
    prev = _current()
    _state.ctx = ctx
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
@dataclasses.dataclass(frozen=True)
class Shared:
    """A placement entry: the dimension holds ``n`` equal pieces (KV
    heads) and more ranks than ``n`` lie along ``axis``; the rank at
    position i of the axis's m ranks holds piece ``i * n // m`` -- the
    KV head its query heads read when m query-head pieces go over n KV
    heads."""
    axis: str
    n: int


@dataclasses.dataclass(frozen=True)
class Packed:
    """A placement entry: the dimension packs ``parts``, (width, split)
    pairs in order; a rank holds, for each part, its piece along
    ``axis`` where ``split`` (the i-th of the axis's m equal pieces) and
    the whole part where not, concatenated in the parts' order."""
    axis: str
    parts: Tuple[Tuple[int, bool], ...]

    def spans(self, m: int, i: int):
        """(start in the whole, width) of each part's slice that rank
        ``i`` of ``m`` holds, in order."""
        out, off = [], 0
        for w, split in self.parts:
            out.append((off + i * (w // m), w // m) if split else (off, w))
            off += w
        return out

    def piece_spans(self, m: int):
        """(start in a rank's piece, width, split) of each part, for
        ``m`` ranks, in order."""
        out, off = [], 0
        for w, split in self.parts:
            n = w // m if split else w
            out.append((off, n, split))
            off += n
        return out


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (Shared, Packed)):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _packed_piece(t: torch.Tensor, dim: int, entry: Packed, m: int,
                  i: int) -> torch.Tensor:
    for w, split in entry.parts:
        if split and w % m:
            raise ValueError(f"a packed part of {w} does not split over "
                             f"{entry.axis} ({m} pieces)")
    if t.shape[dim] != sum(w for w, _ in entry.parts):
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not the "
                         f"packed parts {entry.parts}")
    return torch.cat([t.narrow(dim, a, w) for a, w in entry.spans(m, i)],
                     dim=dim)


def local_piece(mesh, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """The view of ``t`` (the whole tensor) that this rank holds under
    placement ``spec``: each split dimension cut into equal pieces,
    this rank's by its coordinates along the entry's axes (a ``Shared``
    entry: its ``n`` pieces, the one this rank reads; a ``Packed`` one:
    a copy, its parts' pieces concatenated)."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        idx = mesh.axis_index(axes)
        if isinstance(entry, Packed):
            t = _packed_piece(t, dim, entry, n, idx)
            continue
        if isinstance(entry, Shared):
            idx, n = idx * entry.n // n, entry.n
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n} pieces)")
        k = t.shape[dim] // n
        t = t.narrow(dim, idx * k, k)
    return t


def gather_piece(mesh, piece: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """The whole tensor from every rank's ``local_piece`` under
    ``spec`` (one all-gather per split dimension; of a ``Shared``
    dimension's copies, the first rank's that holds each piece; of a
    ``Packed`` one's whole parts, the first rank's)."""
    for dim in reversed(range(len(spec))):
        axes = _entry_axes(spec[dim])
        if not axes or mesh.axis_size(axes) == 1:
            continue
        parts = list(mesh.all_gather(piece.contiguous(), axes).unbind(0))
        if isinstance(spec[dim], Packed):
            piece = _packed_whole(parts, dim, spec[dim])
            continue
        if isinstance(spec[dim], Shared):
            m, n = len(parts), spec[dim].n
            parts = [parts[next(i for i in range(m) if i * n // m == j)]
                     for j in range(n)]
        piece = torch.cat(parts, dim=dim)
    return piece


def _packed_whole(pieces, dim: int, entry: Packed) -> torch.Tensor:
    """The whole of a ``Packed`` dimension from the m ranks' pieces."""
    cols = []
    for lo, n, split in entry.piece_spans(len(pieces)):
        cols += ([p.narrow(dim, lo, n) for p in pieces] if split
                 else [pieces[0].narrow(dim, lo, n)])
    return torch.cat(cols, dim=dim)


def packed_entry(spec: Tuple):
    """(dimension, entry) of a placement's ``Packed`` entry, or None."""
    for dim, e in enumerate(spec):
        if isinstance(e, Packed):
            return dim, e
    return None


def model_split(spec: Tuple) -> bool:
    """Whether a placement cuts a dimension over ``model`` into pieces
    of their own (a ``Shared`` dimension's pieces are held by several
    ranks each; a ``Packed`` one's whole parts by every rank, summed by
    the train step apart)."""
    return any("model" in _entry_axes(e) for e in spec
               if e is not None and not isinstance(e, Shared))


def shared_entry(spec: Tuple):
    """(dimension, entry) of a placement's ``Shared`` entry, or None."""
    for dim, e in enumerate(spec):
        if isinstance(e, Shared):
            return dim, e
    return None


def is_split(mesh, spec: Tuple) -> bool:
    """Whether ``spec`` cuts anything on ``mesh``."""
    return any(mesh.axis_size(_entry_axes(e)) > 1 for e in spec
               if _entry_axes(e))


# -- activations -------------------------------------------------------------
def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x``, after checking that this rank holds the piece the active
    rules give it; the identity without active rules.  Dimension i
    names logical axis ``logical[i]``; its global size is the size the
    active context declares for that axis (``use_rules(..., sizes=)``),
    else unknown and not checked.  A global size N over an axis of n
    ranks is held as N / n where n divides it, else whole (a placement
    replicates what does not divide)."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, rules, sizes = ctx
    if len(logical) != x.dim():
        raise ValueError(f"constrain: {len(logical)} axes {logical} for a "
                         f"tensor of shape {tuple(x.shape)}")
    for i, a in enumerate(logical):
        N = sizes.get(a) if a else None
        if N is None:
            continue
        axes = _entry_axes(rules.get(_RULE_OF.get(a, a))) if a else ()
        n = mesh.axis_size(axes) if axes else 1
        want = N // n if n > 1 and N % n == 0 else N
        if x.shape[i] != want:
            raise ValueError(
                f"constrain: dimension {i} ({a}) of {tuple(x.shape)} holds "
                f"{x.shape[i]}; its placement over {axes or 'no axis'} "
                f"gives {want} of {N}")
    return x


# -- the model axis's collectives ----------------------------------------------
def model_mesh():
    """The active mesh when its ``model`` axis has more than one rank,
    else None."""
    mesh = active_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def _check_grad(mesh) -> None:
    """Refuse autograd over thread ranks that share a card: they share
    its autograd device thread, so a collective in one rank's backward
    pass would wait on a peer queued behind it."""
    if torch.is_grad_enabled() and mesh.threads_share_card:
        raise RuntimeError(
            "a model-axis collective while autograd records, on thread "
            "ranks that share a card (one autograd device thread): run "
            "the ranks as processes (launch.mesh.spawn_ranks) or under "
            "torch.no_grad() (the serve and prefill steps)")


def _records(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A half-precision tensor in float32, for a sum: every model-axis
    sum is float32, rounded once by its caller."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


class _AllReduce(torch.autograd.Function):
    """Sum over the model axis; the backward pass sums the gradient
    over it (an all-reduce is its own adjoint)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.clone(memory_format=torch.contiguous_format),
                               "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(
            g.clone(memory_format=torch.contiguous_format), "model"), None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; the backward pass reduce-scatters the
    gradient (summed in float32, rounded once)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        parts = mesh.all_gather(t.contiguous(), "model")
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(_wide(g), "model", ctx.dim).to(
            g.dtype), None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim``; the backward pass all-gathers the
    gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(t, "model", dim)

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.all_gather(g.contiguous(), "model")
        return torch.cat(list(parts.unbind(0)), dim=ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` over the model axis; the exchange is its own
    adjoint, so the backward pass sends each gradient piece back."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(t, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, "model"), None


def model_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active mesh's model axis (in place where
    autograd records nothing); ``t`` itself without one."""
    mesh = model_mesh()
    if mesh is None:
        return t
    _check_grad(mesh)
    if not _records(t):
        return mesh.all_reduce(t, "model")
    return _AllReduce.apply(t, mesh)


def model_all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the model axis, outside
    autograd (a shift, such as a log-sum-exp's, that the result does
    not depend on)."""
    mesh = model_mesh()
    if mesh is None:
        return t.detach()
    _check_grad(mesh)
    return mesh.all_reduce(t.detach().clone(), "model", op="max")


def model_all_to_all(t: torch.Tensor) -> torch.Tensor:
    """``Mesh.all_to_all`` of ``t`` (n, ...) over the active mesh's model
    axis; ``t`` itself without one."""
    mesh = model_mesh()
    if mesh is None:
        return t
    _check_grad(mesh)
    if not _records(t):
        return mesh.all_to_all(t, "model")
    return _AllToAll.apply(t, mesh)


def seq_gather(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism's entry to a column-parallel product: every
    model rank's sequence piece ``t`` concatenated along ``dim``; the
    backward pass reduce-scatters the gradient."""
    mesh = model_mesh()
    if mesh is None:
        return t
    _check_grad(mesh)
    return _GatherSeq.apply(t, mesh, dim)


def seq_scatter(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism's exit from a row-parallel product: the
    ranks' partial results ``t`` summed and cut along ``dim``, this
    rank's piece (unrounded: the caller rounds once); the backward pass
    all-gathers the gradient."""
    mesh = model_mesh()
    if mesh is None:
        return t
    _check_grad(mesh)
    return _ScatterSeq.apply(t, mesh, dim)


def seq_piece(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This model rank's piece along ``dim`` of a tensor every rank
    holds whole (a view; its gradient is this rank's share)."""
    mesh = model_mesh()
    if mesh is None:
        return t
    n = t.shape[dim] // mesh.shape["model"]
    return t.narrow(dim, mesh.axis_index("model") * n, n)


def model_sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares over the last dimension of ``x``, in
    float32 (..., 1), summed over the model axis: the mean of squares
    of a norm over a width whose pieces the model ranks hold (divide by
    the whole width).  Its backward pass is the all-reduce's adjoint, an
    all-reduce."""
    xf = x.float()
    return model_all_reduce((xf * xf).sum(dim=-1, keepdim=True))


def is_piece(t: torch.Tensor, whole: int, dim: int = -1) -> bool:
    """Whether ``t`` holds a model rank's piece of dimension ``dim``,
    ``whole`` wide in the model: the one test of a leaf's placement
    that the models make from its shape."""
    return t.shape[dim] != whole


def width_piece(t: torch.Tensor, width: int, dim: int = -1) -> torch.Tensor:
    """This model rank's piece, ``width`` wide, of dimension ``dim`` of
    ``t``, which every rank holds whole (per-head vectors used beside
    weights split by heads): ``t`` itself where ``width`` is the whole;
    else, of its n = size / width pieces, the one this rank reads --
    piece ``i * n // tp`` (i its model position), ``Shared``'s rule,
    which for n = tp is piece i.  A view: its gradient is this rank's
    share."""
    if not is_piece(t, width, dim):
        return t
    mesh = model_mesh()
    n = t.shape[dim] // width
    j = mesh.axis_index("model") * n // mesh.shape["model"]
    return t.narrow(dim, j * width, width)


def seq_parallel(seq_len: int) -> bool:
    """Whether the residual stream of a ``seq_len``-token sequence is
    split over the model axis: the active rules map ``seq`` onto a model
    axis above 1 and it divides the sequence (what does not divide stays
    whole, as ``constrain`` holds it)."""
    mesh = model_mesh()
    if mesh is None:
        return False
    return (_current()[1].get("seq") == "model"
            and seq_len % mesh.shape["model"] == 0)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of half-precision CUDA operands with a float32 output;
    the backward pass rounds the float32 gradient once and takes half
    products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g @ b.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = (a.reshape(-1, a.shape[-1]).T
                      @ g.reshape(-1, g.shape[-1]))
            else:
                gb = a.transpose(-1, -2) @ g
        return ga, gb


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., K) by b (K, N), or a (E, M, K) by b (E, K, N))
    as an unrounded float32 result.  Half-precision operands on the
    card go to cuBLAS as they are, accumulating and writing in float32
    (``out_dtype``), so no float32 copy of a weight is made, and where
    autograd records, the gradient is rounded once to their dtype;
    elsewhere both operands are cast."""
    if (a.is_cuda and a.dtype in (torch.bfloat16, torch.float16)
            and b.dtype == a.dtype):
        if _records(a, b):
            return _MatmulF32.apply(a, b)
        return _mm_f32(a, b)
    return a.float() @ b.float()


def partial_sum(y: torch.Tensor, seq_parallel: bool = False
                ) -> torch.Tensor:
    """The ranks' float32 partial results ``y`` summed over the model
    axis, unrounded: the caller rounds the total once.  With
    ``seq_parallel`` (``y`` (B, S, ...)) the sum is reduce-scattered:
    this rank's sequence piece."""
    if model_mesh() is None:
        return y
    if seq_parallel:
        return seq_scatter(y.float(), 1)
    return model_all_reduce(y.float())


def row_parallel(x: torch.Tensor, w: torch.Tensor, split: bool,
                 seq_parallel: bool = False) -> torch.Tensor:
    """``x @ w``, where with ``split`` ``x`` holds this rank's columns
    and ``w`` its rows: each rank's product in float32
    (``matmul_f32``), summed over the model axis (reduce-scattered to
    this rank's sequence piece with ``seq_parallel``), rounded once to
    ``x``'s dtype -- the one rounding of the one-device product."""
    if not split or model_mesh() is None:
        return x @ w
    return partial_sum(matmul_f32(x, w), seq_parallel).to(x.dtype)


def whole_seq_row_parallel(x: torch.Tensor, w: torch.Tensor, split: bool,
                           seq_parallel: bool = False) -> torch.Tensor:
    """``row_parallel`` for a layer whose input holds the whole sequence
    under sequence parallelism (a recurrence, which needs every earlier
    token): split, the sum is reduce-scattered to this rank's piece;
    whole (replicated weights), every rank's product is whole and this
    rank keeps its piece."""
    y = row_parallel(x, w, split, seq_parallel and split)
    return seq_piece(y, 1) if seq_parallel and not split else y


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 seq_parallel: bool = False) -> torch.Tensor:
    """Rows of a vocab-parallel embedding: this rank's ``table`` holds
    vocabulary ids ``[i * V_l, (i + 1) * V_l)`` (i its model position);
    it looks up the tokens in that range, writes zeros for the rest,
    and the ranks' rows are summed (exactly: one rank adds a row, the
    others zeros) -- reduce-scattered to this rank's sequence piece of
    ``tokens`` (B, S) with ``seq_parallel``."""
    mesh = model_mesh()
    if mesh is None:
        return table[tokens.long()]
    vl = table.shape[0]
    idx = tokens.long() - mesh.axis_index("model") * vl
    inside = (idx >= 0) & (idx < vl)
    x = table[idx.clamp(0, vl - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return partial_sum(x, seq_parallel).to(x.dtype)


def gather_model(t: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """Every model-axis rank's piece ``t`` concatenated on ``dim``, in
    rank order (the active mesh's unless ``mesh`` is given); where
    autograd records, the backward pass reduce-scatters the
    gradient."""
    mesh = mesh if mesh is not None else model_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return t
    _check_grad(mesh)
    if _records(t):
        return _GatherSeq.apply(t, mesh, dim % t.dim())
    parts = mesh.all_gather(t.contiguous(), "model")
    return torch.cat(list(parts.unbind(0)), dim=dim)
