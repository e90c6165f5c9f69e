"""Device meshes over torch.distributed ranks.

Counterpart of ``repro.launch.mesh``.  The reference's ``Mesh`` names the
axes of a grid of devices and XLA inserts the collectives; here a mesh is
one rank's view of an SPMD program: the axis names and sizes, this
rank's coordinates, and one explicit ``ProcessGroup`` per set of axes
(an axis group holds the ranks that share every other coordinate).  No
default process group is made: every group is built directly over one
store with a prefix of its own, so several meshes live in one process.

Ranks are numbered row-major over the mesh shape, as ``jax.make_mesh``
orders its devices, so a gather over ``("pod", "data")`` concatenates in
the reference's order.

Four ways to get a mesh:

* ``run_ranks(shape, fn)`` / ``make_host_mesh``: one thread per rank in
  this process, the groups built over one in-process ``HashStore`` (no
  TCP store, no environment variable, no ``init_process_group``) -- the
  tests' mesh, and the counterpart of the reference's host mesh over
  forced host devices.  The runner gives every group a timeout of at
  most 20 s, joins every thread with a deadline, shuts down every group
  it built whether or not a rank failed (a gloo group left behind after
  a failed peer can abort the whole process later), and raises the
  earliest rank exception in the caller.  Thread ranks on one card
  share its autograd device thread, so a collective inside a backward
  pass would wait on a peer queued behind it: such a mesh says so
  (``Mesh.threads_share_card``) and the model axis refuses autograd on
  it (``launch/shardings.py``);
* ``spawn_ranks(shape, fn)``: one process per rank (``python -m
  repro_torch.launch.rank``, never ``multiprocessing``, which would
  re-import the caller's ``__main__``), each building its mesh with
  ``Mesh.from_env`` over a TCP store on 127.0.0.1 that this process
  hosts; the same discipline as ``run_ranks`` (a timeout per group, a
  deadline, every child killed and reaped in a ``finally``, the earliest
  rank failure raised here).  Processes may share one card
  (``device="cuda:0"``), each with its own autograd engine;
  ``spawn_processes`` runs any command under the same environment
  contract as ``torchrun``;
* ``Mesh.from_env()``: one process per rank under ``torchrun`` (its
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``); a process not launched that way is a world of one;
* ``make_production_mesh``: the reference's (16, 16) and (2, 16, 16)
  shapes, which need that many ranks;
* ``placeholder_mesh(shape, rank)`` (or ``make_production_mesh(...,
  placeholder=True)``): one rank of any mesh with no process groups, on
  meta tensors -- the dry run's mesh (``launch/dryrun.py``), the
  counterpart of the reference's placeholder host devices.  Its
  collectives return outputs of the right shape, talk to nobody, and are
  counted in ``Mesh.stats`` exactly as a real rank counts them.

Collectives: ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all`` (the MoE expert exchange) and ``broadcast``, each counted
and timed on the host in ``Mesh.stats``, and billed to the active cost
recorder (``cost/accounting.py``) under the reference's rule: output
bytes, by kind (``COLL_KIND``), with the axes and the global ranks of
the group it ran over, which the roofline's link rates read.
The backend is the caller's choice and never changes on failure.
``nccl`` keeps tensors on the card and needs one card per rank: a mesh
whose ranks would share a card raises before it builds anything.
``gloo`` reduces CPU tensors; the torch.distributed documentation lists
all-reduce and broadcast as its only CUDA collectives, so for a CUDA
tensor every collective of the mesh stages it through pinned host memory
and counts the bytes staged (``CommStats.staged_bytes``).
``Mesh.describe()`` prints the backend and this rule in one line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.cost import accounting as _acct
from repro_torch.device import resolve_device

#: the runner's ceiling on a group's timeout, seconds
MAX_TIMEOUT = 20.0
#: a process rank's group timeout: full-width ranks start seconds apart
SPAWN_TIMEOUT = 120.0
#: each collective's kind in the cost account (the reference's HLO
#: opcodes); a broadcast from one position, which XLA never needs for a
#: replicated value, is billed as the point-to-point kind
#: a placeholder rank's process group: collectives over it talk to nobody
_NOBODY = object()
COLL_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             "broadcast": "collective-permute"}


def _axis_names(ndim: int) -> Tuple[str, ...]:
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh shape has 2 axes (data, model) or 3 (pod, "
                     f"data, model), got {ndim}")


def batch_axes(mesh: "Mesh") -> Tuple[str, ...]:
    """The axes the batch is sharded over: ``("pod", "data")`` as far as
    the mesh has them."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass
class CommStats:
    """One rank's collectives: calls, the bytes this rank handed in and
    the host seconds from a call's entry to its return (staging and the
    wait for its peers included), by op; the bytes copied between the
    card and pinned host memory for a gloo group (both directions)."""
    calls: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    bytes: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    seconds: Dict[str, float] = dataclasses.field(
        default_factory=collections.Counter)
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()
        self.staged_bytes = 0

    def to_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds),
                "staged_bytes": self.staged_bytes}


@dataclasses.dataclass
class _Group:
    pg: Any                  # the backend's ProcessGroup; None alone
    ranks: Tuple[int, ...]   # global ranks, in the group's order
    index: int               # this rank's position in ``ranks``

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """One rank's view of a device mesh (see the module docstring).

    ``shape`` maps each axis name to its size, in axis order;
    ``coords`` this rank's coordinate on each axis;
    ``threads_share_card``: the ranks are threads of one process on one
    card (``run_ranks`` on CUDA), which share its autograd device
    thread; ``placeholder``: a rank with no process groups
    (``placeholder_mesh``), whose collectives talk to nobody."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, *, backend: Optional[str], device,
                 groups: Optional[Dict[Tuple[str, ...], _Group]] = None,
                 threads_share_card: bool = False,
                 placeholder: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, shape)))
        self.backend = backend
        self.device = torch.device(device)
        self.stats = CommStats()
        self._groups = groups if groups is not None else {}
        self.threads_share_card = threads_share_card
        self.placeholder = placeholder

    # -- axes ----------------------------------------------------------
    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"axis {a!r} is not in mesh {self.shape}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (one name or several)."""
        return math.prod(self.shape[a] for a in self._key(axes))

    def axis_index(self, axes) -> int:
        """This rank's position along ``axes``, row-major over them."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes) -> Tuple[int, ...]:
        """The global ranks that share every coordinate off ``axes``, in
        row-major order along them."""
        key = self._key(axes)
        free = [self.axis_names.index(a) for a in key]
        out = []
        for k in range(self.axis_size(key)):
            c = list(_unravel(self.rank, self.shape.values()))
            for i, v in zip(free, _unravel(k, [self.shape[a] for a in key])):
                c[i] = v
            out.append(_ravel(c, list(self.shape.values())))
        return tuple(out)

    def _group(self, axes) -> _Group:
        key = self._key(axes)
        g = self._groups.get(key)
        if g is None:
            if self.placeholder and key in _group_keys(self.axis_names):
                # the group a real rank builds (``_build``), with nobody
                ranks = self.group_ranks(key)
                return _Group(_NOBODY, ranks, ranks.index(self.rank))
            if self.axis_size(key) == 1:
                return _Group(None, (self.rank,), 0)
            raise KeyError(f"mesh has no process group over {key}; it was "
                           f"built with {sorted(self._groups)}")
        return g

    def describe(self) -> str:
        """The mesh, its backend and the staging rule, in one line."""
        where = self.device
        if self.backend == "gloo" and self.device.type == "cuda":
            rule = ("gloo on CUDA tensors: every collective stages them "
                    "through pinned host memory (bytes counted)")
        elif self.backend == "gloo":
            rule = "gloo on CPU tensors: no staging"
        elif self.backend == "nccl":
            rule = "nccl: tensors stay on the card, one card per rank"
        elif self.placeholder:
            rule = ("placeholder: no process groups, collectives talk to "
                    "nobody and return outputs of the right shape")
        else:
            rule = "one rank: collectives are the identity"
        ranks = ("; thread ranks sharing the card: no collective inside "
                 "autograd" if self.threads_share_card else "")
        return (f"mesh {self.shape} rank {self.rank}/{self.size} on {where}; "
                f"backend {self.backend}; {rule}{ranks}")

    # -- collectives ---------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.stats.staged_bytes += t.numel() * t.element_size()
        return h

    def _from_host(self, t: torch.Tensor, h: torch.Tensor) -> None:
        t.copy_(h)
        self.stats.staged_bytes += h.numel() * h.element_size()

    @contextlib.contextmanager
    def _count(self, op: str, t: torch.Tensor, g: _Group, axes,
               out_bytes: int):
        """Count a collective of ``t`` over group ``g`` (``axes``), bill
        its ``out_bytes`` to the active cost recorder, and time the block
        that runs it."""
        self.stats.calls[op] += 1
        self.stats.bytes[op] += t.numel() * t.element_size()
        if _acct._OPEN[0]:
            _acct.bill_collective(COLL_KIND[op], out_bytes, self._key(axes),
                                  g.ranks)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.seconds[op] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """Sum (``op="sum"``) or maximum (``"max"``) of ``t`` over
        ``axes``, in place; returns ``t``."""
        g = self._group(axes)
        if g.pg is None:
            return t
        with self._count("all_reduce", t, g, axes, _nbytes(t)):
            if g.pg is _NOBODY:
                return t
            opts = dist.AllreduceOptions()
            opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op]
            buf = self._to_host(t) if self._staged(t) else t
            g.pg.allreduce([buf], opts).wait()
            if buf is not t:
                self._from_host(t, buf)
        return t

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's ``t`` along ``axes``: (n, *t.shape), in the
        axes' row-major order."""
        g = self._group(axes)
        if g.pg is None:
            return t.unsqueeze(0).clone()
        with self._count("all_gather", t, g, axes, g.size * _nbytes(t)):
            src = t.contiguous()
            if self._staged(src):
                src = self._to_host(src)
                out = torch.empty((g.size,) + tuple(t.shape), dtype=t.dtype,
                                  pin_memory=True)
            else:
                out = torch.empty((g.size,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device)
            if g.pg is _NOBODY:
                return out
            g.pg._allgather_base(out.view(-1), src.view(-1)).wait()
            if out.device != t.device:
                host = out
                out = torch.empty(host.shape, dtype=host.dtype,
                                  device=t.device)
                self._from_host(out, host)
        return out

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """The sum of ``t`` over ``axes``, cut into the group's n equal
        pieces along ``dim``: this rank's piece (position i gets piece
        i), a new tensor."""
        g = self._group(axes)
        if t.shape[dim] % g.size:
            raise ValueError(f"reduce_scatter over {g.size} ranks: dimension "
                             f"{dim} of {tuple(t.shape)} does not split")
        if g.pg is None:
            return t.clone()
        with self._count("reduce_scatter", t, g, axes,
                         _nbytes(t) // g.size):
            chunks = [c.contiguous() for c in t.chunk(g.size, dim)]
            if self._staged(t):
                chunks = [self._to_host(c) for c in chunks]
                out = torch.empty(chunks[0].shape, dtype=t.dtype,
                                  pin_memory=True)
            else:
                out = torch.empty(chunks[0].shape, dtype=t.dtype,
                                  device=t.device)
            if g.pg is _NOBODY:
                return out
            g.pg.reduce_scatter([out], [chunks],
                                dist.ReduceScatterOptions()).wait()
            if out.device != t.device:
                host = out
                out = torch.empty(host.shape, dtype=host.dtype,
                                  device=t.device)
                self._from_host(out, host)
        return out

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Exchange along ``axes``: ``t`` is (n, ...) with n the group's
        size; piece j goes to position j, and piece i of the result came
        from position i (``jax.lax.all_to_all`` with ``split_axis =
        concat_axis = 0``, untiled)."""
        g = self._group(axes)
        if t.shape[0] != g.size:
            raise ValueError(f"all_to_all over {g.size} ranks takes a "
                             f"leading dim of {g.size}, got {tuple(t.shape)}")
        if g.pg is None:
            return t.clone()
        with self._count("all_to_all", t, g, axes, _nbytes(t)):
            src = t.contiguous()
            if self._staged(src):
                src = self._to_host(src)
                out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            else:
                out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            if g.pg is _NOBODY:
                return out
            g.pg.alltoall_base(out, src, [], [],
                               dist.AllToAllOptions()).wait()
            if out.device != t.device:
                host = out
                out = torch.empty(host.shape, dtype=host.dtype,
                                  device=t.device)
                self._from_host(out, host)
        return out

    def broadcast(self, t: torch.Tensor, axes=None, src: int = 0
                  ) -> torch.Tensor:
        """Position ``src``'s ``t`` along ``axes`` (every axis by
        default) to every rank of the group, in place; returns ``t``."""
        axes = self.axis_names if axes is None else axes
        g = self._group(axes)
        if g.pg is None:
            return t
        with self._count("broadcast", t, g, axes, _nbytes(t)):
            if g.pg is _NOBODY:
                return t
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            opts.rootTensor = 0
            buf = self._to_host(t) if self._staged(t) else t
            g.pg.broadcast([buf], opts).wait()
            if buf is not t:
                self._from_host(t, buf)
        return t

    def barrier(self) -> None:
        """Every rank of the mesh reaches this point (a one-element
        all-reduce on the mesh's device)."""
        self.all_reduce(torch.zeros(1, device=self.device), self.axis_names)

    def shutdown(self) -> None:
        """Release every group's connections (see ``_shutdown``)."""
        for g in self._groups.values():
            if g.pg is not None:
                _shutdown(g.pg)

    # -- construction --------------------------------------------------
    @classmethod
    def from_env(cls, shape: Optional[Sequence[int]] = None, *,
                 backend: Optional[str] = None, device="cuda",
                 timeout: float = 600.0) -> "Mesh":
        """This process's rank of a ``torchrun`` launch: ``shape``
        (default ``(WORLD_SIZE, 1)``, data by model) over the world,
        groups over a TCP store at ``MASTER_ADDR:MASTER_PORT`` (the
        launcher's own store when torchrun offers it).
        ``device="cuda"`` takes card ``LOCAL_RANK`` and the
        ``nccl`` backend; a card named by its index (``"cuda:0"``) is
        taken as it is, whatever the rank, so that processes can share
        it, and then the backend is ``gloo`` (nccl takes one card a
        rank); ``cpu`` takes ``gloo``; ``backend`` overrides.  A process
        not under torchrun is a world of one, whose collectives are the
        identity."""
        env = os.environ
        world = int(env.get("WORLD_SIZE", "1"))
        shape = tuple(shape) if shape is not None else (world, 1)
        if math.prod(shape) != world:
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"ranks; the world has {world}")
        names = _axis_names(len(shape))
        dev = torch.device(device)
        shared = dev.type == "cuda" and dev.index is not None
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        backend = backend or ("gloo" if shared or dev.type != "cuda"
                              else "nccl")
        if "RANK" not in env:
            if world != 1:
                raise ValueError(f"WORLD_SIZE {world} without RANK: launch "
                                 f"under torchrun")
            return cls(names, shape, 0, backend=None, device=dev)
        rank = int(env["RANK"])
        td = datetime.timedelta(seconds=timeout)
        agent = env.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
        store = dist.TCPStore(env["MASTER_ADDR"], int(env["MASTER_PORT"]),
                              world, is_master=(rank == 0 and not agent),
                              timeout=td)
        store = dist.PrefixStore("repro_torch_mesh/", store)
        _check_devices(backend, [dev])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return _build(names, shape, rank, backend, dev, store, timeout)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _unravel(k: int, shape) -> Tuple[int, ...]:
    out = []
    for n in reversed(list(shape)):
        out.append(k % n)
        k //= n
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    k = 0
    for c, n in zip(coords, shape):
        k = k * n + c
    return k


def _group_keys(names: Tuple[str, ...]) -> List[Tuple[str, ...]]:
    """The axis sets a mesh builds groups for: each axis, the batch
    axes together, and the whole mesh."""
    keys = [(a,) for a in names]
    bax = tuple(a for a in ("pod", "data") if a in names)
    for k in (bax, names):
        if len(k) > 1 and k not in keys:
            keys.append(k)
    return keys


def _make_pg(backend: str, store, rank: int, size: int, timeout: float):
    td = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = td
        return dist.ProcessGroupGloo(store, rank, size, opts)
    if backend == "nccl":
        if not hasattr(dist, "ProcessGroupNCCL"):
            raise RuntimeError("this torch build has no NCCL backend")
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")


def _build(names, shape, rank, backend, device, store, timeout,
           register: Optional[Callable[[Any], None]] = None,
           threads_share_card: bool = False) -> Mesh:
    """Rank ``rank``'s mesh with one group per axis set of
    ``_group_keys``, each over ``store`` under a prefix naming the set
    and the coordinates off it; every rank builds the sets in the same
    order.  ``register`` sees each group as it is made."""
    mesh = Mesh(names, shape, rank, backend=backend, device=device,
                threads_share_card=threads_share_card)
    for key in _group_keys(mesh.axis_names):
        ranks = mesh.group_ranks(key)
        off = ",".join(f"{a}{mesh.coords[a]}" for a in mesh.axis_names
                       if a not in key)
        sub = dist.PrefixStore(f"{'+'.join(key)}/{off}/", store)
        pg = _make_pg(backend, sub, ranks.index(rank), len(ranks), timeout)
        if register is not None:
            register(pg)
        mesh._groups[key] = _Group(pg, ranks, ranks.index(rank))
    return mesh


def _check_devices(backend: str, devices: List[torch.device]):
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("the nccl backend takes CUDA devices only")
        if len(set(devices)) < len(devices):
            raise ValueError(
                f"nccl needs one card per rank; {len(devices)} ranks would "
                f"share {len(set(devices))} card(s) -- use the gloo backend "
                f"to share a card")


def _rank_devices(backend: str, device, n: int) -> List[torch.device]:
    """Each rank's device: the given CPU or card for gloo (ranks share
    it), ``cuda:0`` .. ``cuda:n-1`` for nccl.  A gloo card must
    exist."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend takes CUDA devices only")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", r if r < count else 0)
                for r in range(n)]
    else:
        devs = [resolve_device(dev)] * n
    _check_devices(backend, devs)
    return devs


def run_ranks(mesh_shape: Sequence[int], fn: Callable[[Mesh], Any], *,
              backend: str = "gloo", device="cuda",
              timeout: float = MAX_TIMEOUT,
              deadline: float = 600.0) -> List[Any]:
    """``fn(mesh)`` on one thread per rank of a ``mesh_shape`` mesh in
    this process; returns each rank's result, by rank.  ``device`` is
    the card by default (``device="cpu"`` for the host), as every entry
    point of the package takes it.

    The groups are built over one ``HashStore``, each with ``timeout``
    seconds (at most ``MAX_TIMEOUT``).  Every thread is joined by
    ``deadline`` seconds after the start; every group built is shut down
    in a ``finally``, whether or not a rank failed; then the earliest
    exception any rank raised is raised here (a rank that failed first
    is the cause, its peers' timeouts the effect).  A rank still running
    at the deadline raises ``TimeoutError`` once its groups are shut
    down and it has had ``timeout`` seconds more to end."""
    if not 0 < timeout <= MAX_TIMEOUT:
        raise ValueError(f"timeout {timeout} s: the runner takes at most "
                         f"{MAX_TIMEOUT} s a group")
    shape = tuple(int(n) for n in mesh_shape)
    names = _axis_names(len(shape))
    n = math.prod(shape)
    devices = _rank_devices(backend, device, n)
    share = n > 1 and devices[0].type == "cuda" and len(set(devices)) == 1
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=timeout))
    built: List[Any] = []
    lock = threading.Lock()
    results: List[Any] = [None] * n
    errors: List[Optional[Tuple[float, BaseException]]] = [None] * n

    def register(pg):
        with lock:
            built.append(pg)

    def body(r: int):
        try:
            if devices[r].type == "cuda":
                torch.cuda.set_device(devices[r])
            mesh = _build(names, shape, r, backend, devices[r], store,
                          timeout, register, threads_share_card=share)
            results[r] = fn(mesh)
        except BaseException as e:      # handed to the caller below
            errors[r] = (time.monotonic(), e)

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"mesh-rank-{r}") for r in range(n)]
    stuck: List[str] = []
    try:
        for t in threads:
            t.start()
        end = time.monotonic() + deadline
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        stuck = [t.name for t in threads if t.is_alive()]
    finally:
        with lock:
            groups = list(built)
        for pg in groups:
            _shutdown(pg)
        for t in threads:
            if t.is_alive():
                t.join(timeout)
    failed = sorted((e[0], r) for r, e in enumerate(errors) if e is not None)
    if failed:
        raise errors[failed[0][1]][1]
    if stuck:
        raise TimeoutError(f"{stuck} still running {deadline} s after the "
                           f"start; their groups were shut down")
    return results


def _shutdown(pg) -> None:
    """Release a group's connections (``shutdown``; ``abort`` where a
    build lacks it).  A group whose peer failed may refuse: that is
    ignored, the point is that nothing of it outlives the run."""
    for name in ("shutdown", "abort"):
        fn = getattr(pg, name, None)
        if fn is not None:
            try:
                fn()
            except RuntimeError:
                continue
            return


@dataclasses.dataclass
class RankProcess:
    """One process of ``spawn_processes``: its exit code (None: killed
    at the deadline), its standard output and error."""
    rank: int
    returncode: Optional[int]
    stdout: str
    stderr: str


def _host_store() -> "dist.TCPStore":
    """A TCP store on 127.0.0.1 at a free port, hosted by this process:
    the counterpart of torchrun's agent store."""
    return dist.TCPStore("127.0.0.1", 0, None, True,
                         timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT),
                         wait_for_workers=False)


def _kill(proc: subprocess.Popen) -> None:
    """Kill a child's whole session (it was started in a session of its
    own) and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def spawn_processes(nproc: int, args: Sequence[str], *,
                    timeout: float = SPAWN_TIMEOUT, deadline: float = 600.0,
                    env: Optional[Dict[str, str]] = None
                    ) -> List[RankProcess]:
    """``sys.executable *args`` in ``nproc`` processes under torchrun's
    environment contract (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and ``MASTER_PORT``
    of a TCP store this process hosts, ``TORCHELASTIC_USE_AGENT_STORE``;
    ``OMP_NUM_THREADS`` 1 unless set, as torchrun sets it), this
    interpreter's ``sys.path`` as the children's ``PYTHONPATH``, and
    ``env`` on top.  Each child runs in a session of its own with its
    output in files.  Once one child has failed, the others get
    ``timeout`` seconds to end (their groups time out); at ``deadline``
    seconds after the start every child still running is killed.  Every
    child is killed and reaped in a ``finally``: none outlives the call.
    Returns each rank's ``RankProcess``."""
    store = _host_store()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
                TORCHELASTIC_USE_AGENT_STORE="True")
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(env or {})
    procs: List[subprocess.Popen] = []
    done = [False] * nproc
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        outs = [open(os.path.join(tmp, f"out{r}"), "w+") for r in range(nproc)]
        errs = [open(os.path.join(tmp, f"err{r}"), "w+") for r in range(nproc)]
        try:
            for r in range(nproc):
                procs.append(subprocess.Popen(
                    [sys.executable, *args], stdin=subprocess.DEVNULL,
                    stdout=outs[r], stderr=errs[r], start_new_session=True,
                    env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
            end = time.monotonic() + deadline
            failed_at = None
            while True:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if not done[r] and p.poll() is not None:
                        done[r] = True
                        if p.returncode and failed_at is None:
                            failed_at = now
                if all(done) or now >= end or (
                        failed_at is not None and now >= failed_at + timeout):
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                _kill(p)
        out = []
        for r, p in enumerate(procs):
            outs[r].seek(0)
            errs[r].seek(0)
            out.append(RankProcess(r, p.returncode if done[r] else None,
                                   outs[r].read(), errs[r].read()))
            outs[r].close()
            errs[r].close()
    del store
    return out


def spawn_ranks(mesh_shape: Sequence[int], fn: Callable[[Mesh], Any], *,
                backend: str = "gloo", device="cuda",
                timeout: float = SPAWN_TIMEOUT, deadline: float = 600.0
                ) -> List[Any]:
    """``fn(mesh)`` in one process per rank of a ``mesh_shape`` mesh;
    returns each rank's result, by rank.

    ``fn`` and its results travel by pickle, so ``fn`` is a module-level
    function (or a ``functools.partial`` of one) that the children can
    import.  Each child (``python -m repro_torch.launch.rank``) builds
    its mesh with ``Mesh.from_env`` (``backend``, ``device``: the card by
    default, ``"cuda:0"`` for processes sharing one, ``"cpu"`` for the
    host; each group with ``timeout`` seconds), runs ``fn``, shuts its
    groups down and exits.  The processes run under
    ``spawn_processes``'s discipline; then the earliest rank failure is
    raised here (the exception the rank raised where it pickles, with
    the rank's traceback as a note), and a rank still running at
    ``deadline`` raises ``TimeoutError``."""
    shape = tuple(int(n) for n in mesh_shape)
    _axis_names(len(shape))
    n = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"fn": fn, "shape": shape, "backend": backend,
                         "device": str(dev), "timeout": timeout}, f)
        procs = spawn_processes(n, ["-m", "repro_torch.launch.rank", job],
                                timeout=timeout, deadline=deadline)
        results, failures = [None] * n, []
        for p in procs:
            path = os.path.join(tmp, f"rank{p.rank}.pkl")
            rec = None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    rec = pickle.load(f)
            if rec is not None and rec[0] == "ok" and p.returncode == 0:
                results[p.rank] = rec[1]
                continue
            if rec is not None and rec[0] == "error":
                _, when, err, tb = rec
                err.add_note(f"rank {p.rank} of mesh {shape}:\n{tb}")
                failures.append((when, p.rank, err))
            elif p.returncode is None:
                failures.append((float("inf"), p.rank, TimeoutError(
                    f"rank {p.rank} still running {deadline} s after the "
                    f"start; killed")))
            else:
                failures.append((float("inf"), p.rank, RuntimeError(
                    f"rank {p.rank} exited with {p.returncode}: "
                    f"{p.stderr[-2000:]}")))
    if failures:
        raise min(failures, key=lambda f: (f[0], f[1]))[2]
    return results


def make_host_mesh(data: Optional[int] = None, model: int = 1, *,
                   fn: Callable[[Mesh], Any], backend: str = "gloo",
                   device="cuda", timeout: float = MAX_TIMEOUT
                   ) -> List[Any]:
    """The reference's ``make_host_mesh(data, model)`` as a run: ``fn``
    on each rank of a (data, model) mesh of threads; ``data`` defaults
    to the cards over ``model`` for nccl, and to 2 for gloo.  Returns
    the ranks' results."""
    if data is None:
        n = torch.cuda.device_count() if backend == "nccl" else 2
        data = max(1, n // model)
    return run_ranks((data, model), fn, backend=backend, device=device,
                     timeout=timeout)


def placeholder_mesh(shape: Sequence[int], rank: int = 0) -> Mesh:
    """Rank ``rank`` of a ``shape`` mesh with no process groups, on the
    meta device: its collectives return outputs of the right shape and
    talk to nobody, and are counted in ``stats`` (calls, bytes handed in)
    and billed to the cost recorder as a real rank's are.  The dry run's
    mesh: a step on meta tensors over it is rank ``rank``'s program."""
    shape = tuple(int(n) for n in shape)
    return Mesh(_axis_names(len(shape)), shape, rank, backend=None,
                device="meta", placeholder=True)


def make_production_mesh(*, multi_pod: bool = False, backend=None,
                         device="cuda", placeholder: bool = False) -> Mesh:
    """This rank of the reference's production mesh: (data 16, model
    16), or (pod 2, data 16, model 16) with ``multi_pod``.  Raises
    unless the torchrun world has that many ranks; with ``placeholder``
    it is rank 0 of ``placeholder_mesh(shape)``, which needs none."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if placeholder:
        return placeholder_mesh(shape)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; this world has {world}")
    return Mesh.from_env(shape, backend=backend, device=device)
