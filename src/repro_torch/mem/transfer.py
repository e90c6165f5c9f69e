"""The multi-queue transfer plane: one DMA engine per direction.

The paper's closing argument is that once software manages physical
blocks directly, data movement stops being an implicit side effect of
address translation and becomes an explicit, schedulable resource -- it
names "chips with multiple DMA devices" as exactly the hardware this
buys leverage on.  This module is the multi-DMA version of that idea: one ``TransferEngine`` per
direction, each with its own FIFO and priority lanes, coordinated by
cross-queue fences -- the shape a chip with separate d2d / d2h / h2d
DMA devices actually has.

Shape of the plane:

  * **engines** -- ``d2d`` (COW fulfilment, compaction relocation),
    ``d2h`` (swap-out gather + host copy), ``h2d`` (swap-in scatter,
    speculative prefetch).  Each ``TransferEngine`` owns a FIFO with a
    per-engine ``seqno`` clock and two lanes: ``urgent`` (the step
    loop's critical path) and ``background`` (speculative work that may
    be cancelled).
  * **``QueueSet``** -- the front-end every producer talks to
    (``enqueue_copy`` / ``enqueue_swap_out`` / ``enqueue_swap_in`` /
    ``dispatch`` / ``complete_dispatched`` / ``drain``), used by
    ``Mapping.migrate``, ``ensure_writable`` and ``Arena.compact``.
    ``TransferQueue`` is an alias.
  * **cross-queue fences** -- a ``Fence`` is an *epoch vector* over
    engines (one seqno per direction), done only when every engine has
    settled its prefix.  Plans carry explicit cross-queue dependencies,
    computed at enqueue against the other engines' pending plans:

      - *launch-strength* (``deps``): a plan that writes blocks an
        earlier plan in another engine still names may not execute
        until that plan has at least launched (a dispatched d2h gather
        has captured its functional snapshot, so launch suffices);
      - *complete-strength* (``fdeps``): an h2d swap-in of owner ``O``
        may not execute until the unfenced d2h of the same owner has
        fully completed (its payload must be ON the host tier).

    Execution is an iterative fixpoint over engines: each pass runs
    every plan whose dependencies are settled and skips the rest;
    skipped plans become eligible as the engines they wait on progress.
    Dependencies always point backwards in global enqueue time, so the
    fixpoint terminates.
  * **d2h reorder window** -- because skipped plans *block only the
    plans that actually conflict with them* (write-read / read-write /
    write-write on the same pool class), independent d2h gathers
    coalesce into one launch ACROSS an intervening dependency: d2h
    plans enqueued on either side of a d2d copy share a gather when the
    dependency check against the copy's destinations passes, and split
    into two launches when it does not (``stats.reordered`` counts the
    wins; the old single-FIFO plane could only batch consecutive
    plans).
  * **speculative plans** -- ``enqueue_swap_in(..., speculative=True)``
    rides the background h2d lane, reads the host payload WITHOUT
    consuming it, and may be cancelled while pending
    (``cancel_plan``): holds release, in-flight flags clear, and the
    payload stays on the host tier for a later real swap-in.  The
    serving engine uses this for LIFO resume prefetch
    (``Mapping.prefetch``/``commit_prefetch``/``cancel_prefetch``).
  * **two-phase d2h** -- ``dispatch()`` launches the device gather
    and its asynchronous copy into pinned host memory, and releases the
    held source blocks; waiting for the host copy is deferred until the
    fence, overlapping the decode in between.
  * **``drain()``** -- the pinned synchronous fallback: execute
    everything (or a fenced epoch-vector prefix, expanded to its
    dependency closure) now.  Token- and byte-identical behavior
    between the overlapped multi-queue schedule and the drained one is
    pinned by the reference's property test and, for this package, by
    the engine tests that hold both schedules to the same tokens.

Execution needs device tensors: clients register an *executor* per pool
class (``register_executor``) exposing the current device streams (the
KV k/v pools) -- get returns the streams, set hands them back.  The
block kernels update the streams in place (``kernels/ops.py``).  Pool
classes with no executor (metadata-only arenas, e.g. unit tests
without a device pool) complete their plans immediately as
residency-only moves.

This module, and only this module, calls the block-movement kernels
and the host tier's payload verbs -- the same rule the reference
package enforces for its own transfer plane.
"""

from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, Iterable, List, Optional,
                    Set, Tuple)

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.mem.arena import Arena

D2D = "d2d"   # device -> device: COW fulfilment, compaction relocation
D2H = "d2h"   # device -> host:   swap-out (gather + host copy)
H2D = "h2d"   # host -> device:   swap-in (scatter), speculative prefetch
DIRECTIONS = (D2D, D2H, H2D)

#: priority lanes within one engine
URGENT = "urgent"          # the step loop's critical path
BACKGROUND = "background"  # speculative work; cancellable while pending
LANES = (URGENT, BACKGROUND)

#: plan lifecycle
PENDING = "pending"        # enqueued, device work not started
DISPATCHED = "dispatched"  # d2h only: gather launched, host copy deferred
DONE = "done"
CANCELLED = "cancelled"    # speculative plan withdrawn before execution


class UnfencedReadError(RuntimeError):
    """A block was read (table built for decode) while a transfer
    targeting it was still unfenced.  The engine's read barrier
    (``QueueSet.dispatch`` before ``_sync_device_state``) makes this
    unreachable in the step loop; reaching it means a client skipped
    the fence."""


class Fence:
    """Cross-queue completion token: an epoch vector over engines.

    ``done`` is true once EVERY engine has settled all plans with
    seqno <= its epoch; ``wait()`` drains exactly those prefixes (plus
    their cross-queue dependency closure).  A fence minted at enqueue
    time covers the new plan AND everything enqueued before it on every
    engine -- the prefix a single global FIFO fence would cover.
    """

    __slots__ = ("queues", "epochs")

    def __init__(self, queues: "QueueSet", epochs: Dict[str, int]):
        self.queues = queues
        self.epochs = dict(epochs)

    @property
    def done(self) -> bool:
        return all(self.queues.engines[d].prefix_done(e)
                   for d, e in self.epochs.items())

    def wait(self) -> None:
        """Synchronously execute every plan this fence covers."""
        self.queues.stats.fences += 1
        self.queues.drain(upto=self.epochs)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Fence({self.epochs} done={self.done})"


@dataclasses.dataclass(eq=False)          # identity semantics: plans are
class TransferPlan:                        # queue entries, not values
    """One batched block-copy descriptor (the compaction plan,
    generalized to every movement verb and both placement tiers)."""

    direction: str                     # d2d | d2h | h2d
    pool_class: str
    kind: str                          # producing verb: cow|compact|swap-out|swap-in|...
    src: Optional[np.ndarray] = None   # device ids read (d2d, d2h)
    dst: Optional[np.ndarray] = None   # device ids written (d2d, h2d)
    owner: object = None               # host-tier payload key (d2h, h2d)
    nbytes: int = 0                    # known at enqueue for d2d, measured for d2h/h2d
    seqno: int = -1                    # PER-ENGINE FIFO position
    lane: str = URGENT
    speculative: bool = False          # prefetch: peek payload, cancellable
    committed: bool = False            # prefetch promoted to the real resume
    abandoned: bool = False            # executed prefetch written off
    state: str = PENDING
    dispatch_mark: int = -1            # compute-mark count at device launch
    #: cross-queue dependencies, computed at enqueue: direction ->
    #: highest seqno in that engine this plan must wait for.  ``deps``
    #: is launch-strength (the dep must no longer be PENDING); ``fdeps``
    #: is complete-strength (the dep must be DONE -- payload landed).
    deps: Dict[str, int] = dataclasses.field(default_factory=dict)
    fdeps: Dict[str, int] = dataclasses.field(default_factory=dict)
    # internal: launched-but-uncopied device gathers, holds, in-flight marks
    _gathered: Optional["_HostCopy"] = dataclasses.field(default=None,
                                                       repr=False)
    _held: list = dataclasses.field(default_factory=list, repr=False)
    _flagged: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        # conflict sets, computed ONCE here instead of per plan per
        # dispatch round (src/dst are frozen after construction): the
        # per-phase walk and the enqueue-time dependency scan both read
        # these instead of rebuilding Python sets in the hot loop
        self._src_ids = (frozenset(int(b) for b in self.src)
                         if self.src is not None else frozenset())
        self._dst_ids = (frozenset(int(b) for b in self.dst)
                         if self.dst is not None else frozenset())
        self._skey = frozenset((self.pool_class, b) for b in self._src_ids)
        self._dkey = frozenset((self.pool_class, b) for b in self._dst_ids)


def _zeroed() -> Dict[str, int]:
    return {d: 0 for d in DIRECTIONS}


@dataclasses.dataclass
class TransferStats:
    """Observability of the transfer plane (``Engine.stats`` carries
    its ``to_dict()``)."""

    enqueued: Dict[str, int] = dataclasses.field(default_factory=_zeroed)
    completed: Dict[str, int] = dataclasses.field(default_factory=_zeroed)
    bytes_moved: Dict[str, int] = dataclasses.field(default_factory=_zeroed)
    launches: int = 0          # device kernel launches / host transfers
    coalesced: int = 0         # plans merged into a shared launch
    reordered: int = 0         # d2h plans coalesced ACROSS a blocked plan
    dispatches: int = 0
    drains: int = 0
    fences: int = 0            # fence phases (complete_dispatched / wait)
    #: PER-ENGINE overlap attribution (a global counter would conflate
    #: h2d prefetch overlap with d2h double buffering).
    #: ``overlapped[d2h]`` counts host copies that landed
    #: only AFTER a compute step ran between their gather launch and
    #: completion; ``overlapped[h2d]`` counts speculative scatters whose
    #: commit came after a compute step ran past their launch.
    overlapped: Dict[str, int] = dataclasses.field(default_factory=_zeroed)
    #: per-engine queue-depth high-water marks
    max_pending: Dict[str, int] = dataclasses.field(default_factory=_zeroed)
    #: speculative (background-lane) plan accounting
    prefetch_enqueued: int = 0
    prefetch_completed: int = 0    # speculative plans that executed
    prefetch_committed: int = 0    # commits (mapping promoted to device)
    prefetch_cancelled: int = 0
    #: Python-side overhead accounting: ``python_launches`` counts per-plan visits in the
    #: dispatch walk -- the inner-loop bookkeeping the step loop pays in
    #: the interpreter; ``dispatches_per_step`` is ``dispatches`` per
    #: compute mark, refreshed on every ``note_compute()``.
    python_launches: int = 0
    dispatches_per_step: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _conflicts(earlier: TransferPlan, src: Set[int], dst: Set[int]) -> bool:
    """Must ``earlier`` execute before a plan reading ``src`` / writing
    ``dst`` of the same pool class?  Write-read, read-write and
    write-write order; read-read does not.  Uses the conflict sets
    precomputed at plan construction, not a fresh set walk."""
    return (bool(earlier._dst_ids & (src | dst))
            or bool(earlier._src_ids & dst))


class TransferEngine:
    """One DMA engine: a per-direction FIFO with its own epoch clock
    and priority lanes (see module docstring)."""

    __slots__ = ("direction", "_pending", "_dispatched", "_seq")

    def __init__(self, direction: str):
        self.direction = direction
        self._pending: List[TransferPlan] = []     # seqno order
        self._dispatched: List[TransferPlan] = []  # d2h two-phase
        self._seq = 0

    @property
    def epoch(self) -> int:
        """Highest seqno stamped so far (-1 when virgin)."""
        return self._seq - 1

    def stamp(self, plan: TransferPlan) -> TransferPlan:
        plan.seqno = self._seq
        self._seq += 1
        return plan

    @property
    def depth(self) -> int:
        return len(self._pending) + len(self._dispatched)

    def unsettled(self) -> List[TransferPlan]:
        return self._pending + self._dispatched

    def prefix_done(self, epoch: int) -> bool:
        return not any(p.seqno <= epoch
                       for p in self._pending + self._dispatched)

    def launched_through(self, epoch: int) -> bool:
        """Every plan with seqno <= epoch has at least launched (a
        dispatched d2h gather has captured its snapshot)."""
        return not any(p.seqno <= epoch for p in self._pending)


class QueueSet:
    """Front-end over the per-direction ``TransferEngine``s: one
    producer API executing on multiple queues with cross-queue fences
    (see module docstring)."""

    def __init__(self, arena: "Arena", eager: bool = False):
        self.arena = arena
        #: eager=True is the synchronous fallback: every enqueue drains
        #: immediately, pinning token-identical behavior for tests/CI.
        self.eager = eager
        self.stats = TransferStats()
        self.engines: Dict[str, TransferEngine] = {
            d: TransferEngine(d) for d in DIRECTIONS}
        self._compute_marks = 0
        # pool class -> (get_streams, set_streams, layered)
        self._executors: Dict[str, Tuple[Callable, Callable, bool]] = {}
        self._observers: Dict[object, Callable[[TransferPlan], None]] = {}

    # ---------------- wiring ----------------
    def register_executor(self, pool_class: str, get_streams: Callable,
                          set_streams: Callable,
                          layered: bool = True) -> None:
        """Bind the device streams of one pool class.

        ``get_streams()`` returns the current list of device arrays
        (layered: ``(L, NB, *block)``; flat: ``(NB, *block)``);
        ``set_streams(list)`` writes the updated arrays back.  The last
        registration wins (an arena handed to a new engine re-binds).
        """
        self._executors[pool_class] = (get_streams, set_streams, layered)

    def has_executor(self, pool_class: str) -> bool:
        """Whether a device payload exists for this pool class (classes
        without an executor complete plans as residency-only moves --
        snapshot/migration can carry no bytes for them)."""
        return pool_class in self._executors

    def is_layered(self, pool_class: str) -> bool:
        """Stream layout of the class's executor: layered streams are
        ``(L, NB, *block)``, flat streams ``(NB, *block)``."""
        return self._executors[pool_class][2]

    def add_observer(self, fn: Callable[[TransferPlan], None],
                     key: Optional[str] = None) -> None:
        """Called once per completed plan (byte ledgers, e.g.
        ``serve/swap.HostBlockStore``).

        A ``key``ed registration REPLACES any earlier observer with the
        same key -- the same last-wins rule as ``register_executor``, so
        re-handing an arena to a new engine does not accumulate (and
        retain) dead ledgers.
        """
        self._observers[key if key is not None else object()] = fn

    def unregister_executor(self, pool_class: str) -> None:
        """Symmetric teardown: drop the executor binding (refuses while
        plans that would need it are outstanding)."""
        if any(p.pool_class == pool_class
               for eng in self.engines.values() for p in eng.unsettled()):
            raise ValueError(
                f"pool class {pool_class!r} has outstanding plans; "
                f"drain() before unregistering its executor")
        self._executors.pop(pool_class, None)

    def remove_observer(self, key: str) -> None:
        self._observers.pop(key, None)

    def note_compute(self) -> None:
        """Mark that a compute step (decode) ran: a transfer launched
        before this mark and completed/committed after it genuinely
        overlapped compute (the per-engine ``overlapped`` stats)."""
        self._compute_marks += 1
        self.stats.dispatches_per_step = round(
            self.stats.dispatches / self._compute_marks, 4)

    # ---------------- queries ----------------
    @property
    def pending(self) -> int:
        """Plans not yet fully executed (pending + dispatched), summed
        over engines."""
        return sum(eng.depth for eng in self.engines.values())

    @property
    def has_undispatched(self) -> bool:
        """Plans whose device work has not launched (these may hold
        freed blocks; ``dispatch()`` releases the holds non-blocking)."""
        return any(eng._pending for eng in self.engines.values())

    def pending_by_direction(self) -> Dict[str, int]:
        return {d: eng.depth for d, eng in self.engines.items()}

    def queue_depths(self) -> Dict[str, Dict[str, int]]:
        """Per-engine live depth split by lane."""
        out = {}
        for d, eng in self.engines.items():
            lanes = {lane: 0 for lane in LANES}
            for p in eng.unsettled():
                lanes[p.lane] += 1
            out[d] = lanes
        return out

    def in_transit(self, pool_class: str) -> List[object]:
        """Owners whose swap-out payload has not reached the host tier
        yet (enqueued or dispatched d2h)."""
        return [p.owner for p in self.engines[D2H].unsettled()
                if p.pool_class == pool_class]

    def in_flight_blocks(self, pool_class: str) -> set:
        """Device ids named as destination by any unexecuted plan."""
        out = set()
        for eng in self.engines.values():
            for p in eng._pending:
                if p.pool_class == pool_class and p.dst is not None:
                    out.update(int(b) for b in p.dst)
        return out

    def last_reference(self, pool_class: str, ids) -> Optional[Dict[str, int]]:
        """Per-engine epoch vector of the last PENDING plans that read
        or write one of ``ids``, or None when nothing does.

        Dispatched d2h plans have already captured their sources, so
        only undispatched plans pin device state.  ``Mapping.free``
        consults this: releasing blocks a pending plan still names
        would let reuse race the plan's execution -- a
        ``drain(upto=<this vector>)`` settles exactly the prefixes that
        matter and leaves later plans overlapped.
        """
        ids = set(int(b) for b in ids)
        epochs: Dict[str, int] = {}
        for d, eng in self.engines.items():
            for p in eng._pending:
                if p.pool_class != pool_class:
                    continue
                for vec in (p.src, p.dst):
                    if vec is not None and any(int(b) in ids for b in vec):
                        epochs[d] = p.seqno
        return epochs or None

    def last_transit(self, pool_class: str, owner) -> Optional[int]:
        """Highest d2h seqno of an unfenced swap-out of ``owner``
        (payload still in transit), or None -- the fence target for
        teardown and the complete-strength dep of a swap-in."""
        last = None
        for p in self.engines[D2H].unsettled():
            if p.pool_class == pool_class and p.owner == owner:
                last = max(p.seqno, last if last is not None else p.seqno)
        return last

    def fence(self) -> Fence:
        """Epoch-vector token covering everything enqueued so far on
        every engine."""
        return Fence(self, {d: eng.epoch
                            for d, eng in self.engines.items()})

    def _done_fence(self) -> Fence:
        """An already-complete fence (empty/no-op plans): waiting on it
        must not serialize unrelated pending transfers."""
        return Fence(self, {d: -1 for d in DIRECTIONS})

    # ---------------- producer API ----------------
    def enqueue_copy(self, pool_class: str, src, dst,
                     kind: str = "cow") -> Fence:
        """d2d: copy block src[i] -> dst[i] on every stream."""
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        if src.size == 0:
            return self._done_fence()
        nbytes = int(src.size) * self.arena.block_nbytes(pool_class)
        return self._enqueue(TransferPlan(D2D, pool_class, kind,
                                          src=src, dst=dst, nbytes=nbytes))

    def enqueue_swap_out(self, pool_class: str, owner, src,
                         kind: str = "swap-out",
                         lane: str = URGENT) -> Fence:
        """d2h: gather ``src`` on device, deposit the compact payload in
        the arena host tier under ``owner`` at the fence.

        ``lane=BACKGROUND`` is the live-migration pre-copy path: gathers
        of LIVE blocks (refcount > 0) take no holds -- they are pure
        reads that ride behind the urgent traffic while decode runs.
        """
        src = np.asarray(src, np.int32).reshape(-1)
        if src.size == 0:
            return self._done_fence()
        return self._enqueue(TransferPlan(D2H, pool_class, kind,
                                          src=src, owner=owner, lane=lane))

    def enqueue_swap_in(self, pool_class: str, owner, dst,
                        kind: str = "swap-in",
                        speculative: bool = False) -> Fence:
        """h2d: scatter ``owner``'s host payload into fresh ids ``dst``.

        ``speculative=True`` rides the background lane, PEEKS the host
        payload instead of consuming it, and stays cancellable while
        pending -- the prefetch half of the multi-queue plane.
        """
        dst = np.asarray(dst, np.int32).reshape(-1)
        if dst.size == 0:
            return self._done_fence()
        plan = TransferPlan(H2D, pool_class, kind, dst=dst, owner=owner,
                            lane=BACKGROUND if speculative else URGENT,
                            speculative=speculative)
        return self._enqueue(plan)

    def enqueue_prefetch(self, pool_class: str, owner, dst) -> TransferPlan:
        """Speculative swap-in on the background h2d lane; returns the
        PLAN (not a fence) so the producer can later ``cancel_plan`` it
        or promote it at commit (``Mapping.prefetch`` holds it)."""
        dst = np.asarray(dst, np.int32).reshape(-1)
        plan = TransferPlan(H2D, pool_class, "swap-in", dst=dst,
                            owner=owner, lane=BACKGROUND, speculative=True)
        self._enqueue(plan)
        return plan

    # ---------------- enqueue internals ----------------
    def _enqueue(self, plan: TransferPlan) -> Fence:
        eng = self.engines[plan.direction]
        eng.stamp(plan)
        self.stats.enqueued[plan.direction] += 1
        if plan.speculative:
            self.stats.prefetch_enqueued += 1
        if plan.pool_class not in self._executors:
            # metadata-only arena: no device payload exists, so the plan
            # completes immediately as a residency-only move (stamped
            # with the current compute mark: an inline completion never
            # overlapped anything)
            plan.state = DONE
            plan.dispatch_mark = self._compute_marks
            self.stats.completed[plan.direction] += 1
            if plan.speculative:
                self.stats.prefetch_completed += 1
            self._notify(plan)
            return Fence(self, {d: (plan.seqno if d == plan.direction
                                    else e.epoch)
                                for d, e in self.engines.items()})
        self._compute_deps(plan)
        self._mark(plan)
        eng._pending.append(plan)
        for d, e in self.engines.items():
            self.stats.max_pending[d] = max(self.stats.max_pending[d],
                                            e.depth)
        fence = Fence(self, {d: (plan.seqno if d == plan.direction
                                 else e.epoch)
                             for d, e in self.engines.items()})
        if self.eager:
            self.drain()
        return fence

    def _compute_deps(self, plan: TransferPlan) -> None:
        """Cross-queue fences, computed once at enqueue: the other
        engines' pending plans this plan conflicts with (launch
        strength), and -- for a swap-in -- the in-transit swap-out of
        the same owner (complete strength: its payload must have
        LANDED, not just launched).  In-engine ordering needs no deps:
        the FIFO plus the blocked-set scan in ``_engine_pass`` keep
        conflicting same-engine plans ordered.
        """
        src, dst = plan._src_ids, plan._dst_ids
        for d, eng in self.engines.items():
            if d == plan.direction:
                continue
            dep = None
            for p in eng._pending:
                if p.pool_class == plan.pool_class \
                        and _conflicts(p, src, dst):
                    dep = p.seqno
            if dep is not None:
                plan.deps[d] = dep
        if plan.direction == H2D:
            last = self.last_transit(plan.pool_class, plan.owner)
            if last is not None:
                plan.fdeps[D2H] = last

    def _mark(self, plan: TransferPlan) -> None:
        """Discipline marks: HOLD freed source blocks (a DMA reads them
        after the allocator let go -- they must not be reallocated
        before the gather launches) and flag destination leases
        ``in_flight`` (their payload is not there yet).  Holds are
        tagged with the reading engine's direction (the per-engine
        hold/release discipline)."""
        st = self.arena._cls(plan.pool_class)
        if plan.src is not None:
            for b in plan.src:
                b = int(b)
                if st.allocator.refcount(b) == 0:
                    if st.allocator.is_held(b):
                        # an earlier pending plan already holds it; move
                        # the hold to this (later) reader so it survives
                        # until the LAST gather over the block launches
                        for eng in self.engines.values():
                            for p in eng._pending:
                                if (p.pool_class == plan.pool_class
                                        and b in p._held):
                                    p._held.remove(b)
                                    break
                        st.allocator.retag_hold(b, plan.direction)
                    else:
                        st.allocator.hold(b, engine=plan.direction)
                    plan._held.append(b)
        if plan.dst is not None:
            for b in plan.dst:
                for lease in st.leases.get(int(b), []):
                    if not lease.in_flight:
                        lease.in_flight = True
                        plan._flagged.append(lease)

    def _release_holds(self, plan: TransferPlan) -> None:
        st = self.arena._cls(plan.pool_class)
        for b in plan._held:
            st.allocator.release_hold(b)
        plan._held = []

    def _clear_flags(self, plan: TransferPlan) -> None:
        for lease in plan._flagged:
            lease.in_flight = False
        plan._flagged = []

    def _notify(self, plan: TransferPlan) -> None:
        for fn in self._observers.values():
            fn(plan)

    # ---------------- cancellation (speculative plans) ----------------
    def cancel_plan(self, plan: TransferPlan) -> bool:
        """Withdraw a PENDING speculative plan: release its holds,
        clear its in-flight lease flags and drop it from its engine's
        FIFO.  The host payload (peeked, never taken, by speculative
        plans) stays intact for a later real swap-in.  Returns False
        when the plan already launched (cancel then means the caller
        releases the now-materialized destination normally)."""
        if plan.state != PENDING:
            return False
        if not plan.speculative:
            raise ValueError(
                f"only speculative plans may be cancelled, got {plan!r}")
        self.engines[plan.direction]._pending.remove(plan)
        self._release_holds(plan)
        self._clear_flags(plan)
        plan.state = CANCELLED
        self.stats.prefetch_cancelled += 1
        return True

    def note_prefetch_commit(self, plan: TransferPlan) -> None:
        """A speculative swap-in was promoted to the real resume; if a
        compute step ran between its scatter launch and this commit,
        the prefetch genuinely overlapped decode (``overlapped[h2d]``
        -- NOT the d2h double-buffer counter).  Observers are re-notified with
        ``plan.committed`` set so byte ledgers fold the parked
        speculative bytes into their demand accounting no matter which
        client performed the resume (``Mapping.migrate`` auto-commit
        included, not just the serving engine)."""
        self.stats.prefetch_committed += 1
        plan.committed = True
        if plan.state == DONE:
            if self._compute_marks > plan.dispatch_mark:
                self.stats.overlapped[H2D] += 1
            self._notify(plan)

    def note_prefetch_abandon(self, plan: TransferPlan) -> None:
        """An EXECUTED speculative swap-in was cancelled: its scatter
        ran for nothing.  Count the waste and re-notify observers with
        ``plan.abandoned`` set so ledgers write the parked bytes off."""
        self.stats.prefetch_cancelled += 1
        plan.abandoned = True
        self._notify(plan)

    # ---------------- execution ----------------
    def dispatch(self, upto: Optional[Dict[str, int]] = None,
                 lanes: Optional[Iterable[str]] = None) -> None:
        """Execute d2d/h2d plans; LAUNCH d2h gathers, deferring their
        host copies to the next ``complete_dispatched``/``drain`` (the
        double-buffer half of the step loop).  ``lanes`` restricts to a
        lane subset (the step loop dispatches the background prefetch
        lane separately, after the urgent critical path).

        Empty-lane fast path: when no pending plan matches the lane
        filter there is nothing to launch, release or unblock -- skip
        the fixpoint entirely (and the ``dispatches`` counter, so the
        stat counts scheduling WORK, not step-loop calls: the serving
        loop dispatches 2+ lanes every step, overwhelmingly no-ops).
        """
        lane_set = None if lanes is None else set(lanes)
        if not any(lane_set is None or p.lane in lane_set
                   for eng in self.engines.values() for p in eng._pending):
            return
        self.stats.dispatches += 1
        self._run_dispatch(self._closure(upto), lanes)

    def complete_dispatched(self, upto: Optional[Dict[str, int]] = None
                            ) -> None:
        """Fence phase: land every launched-but-uncopied d2h payload.
        Skipped (no counter) when nothing was dispatched."""
        if not self.engines[D2H]._dispatched:
            return
        self.stats.fences += 1
        self._run_complete(upto)

    def drain(self, upto: Optional[Dict[str, int]] = None) -> None:
        """Synchronous fallback: execute everything (or the fenced
        epoch-vector prefix, expanded to its cross-queue dependency
        closure) now.  Skipped (no counter) when the plane is empty."""
        if self.pending == 0:
            return
        self.stats.drains += 1
        limits = self._closure(upto)
        self._run_dispatch(limits, None)
        self._run_complete(limits)

    def _closure(self, upto: Optional[Dict[str, int]]
                 ) -> Optional[Dict[str, int]]:
        """Expand an epoch vector until it covers the cross-queue
        dependencies of every plan it names -- draining a d2h prefix
        must also drain the d2d copies those gathers wait on."""
        if upto is None:
            return None
        limits = {d: upto.get(d, -1) for d in DIRECTIONS}
        changed = True
        while changed:
            changed = False
            for d, eng in self.engines.items():
                for p in eng._pending:
                    if p.seqno > limits[d]:
                        continue
                    for dep in (p.deps, p.fdeps):
                        for dd, e in dep.items():
                            if e > limits[dd]:
                                limits[dd] = e
                                changed = True
        return limits

    def _run_dispatch(self, limits: Optional[Dict[str, int]],
                      lanes: Optional[Iterable[str]]) -> None:
        """Iterative fixpoint over engines: every pass executes the
        plans whose cross-queue dependencies are settled and skips the
        rest; skipped plans unblock as the engines they wait on
        progress.  Dependencies point backwards in enqueue time, so the
        loop terminates.  The d2h engine goes first each round so
        independent gathers launch ahead of the copies/scatters they do
        not depend on (the reorder window).

        Each pass also reports how many in-scope plans it left behind:
        when every engine comes back empty the fixpoint is reached and
        the loop exits WITHOUT the classic extra no-progress
        verification round -- the common single-phase step pays exactly
        one walk per engine (the ``python_launches`` stat counts the
        per-plan visits those walks cost)."""
        lanes = None if lanes is None else set(lanes)
        while True:
            progressed, remaining = False, 0
            for d in (D2H, D2D, H2D):
                prog, left = self._engine_pass(d, limits, lanes)
                progressed |= prog
                remaining += left
            if not remaining or not progressed:
                break

    def _engine_pass(self, direction: str,
                     limits: Optional[Dict[str, int]],
                     lanes: Optional[Set[str]]) -> Tuple[bool, int]:
        """One scheduling pass over one engine's FIFO: batch and run
        every eligible plan; skipped plans (lane-filtered, beyond the
        fence limit, or waiting on another engine) block exactly the
        later plans that conflict with them -- independent plans
        execute PAST them, which is what lets d2h gathers coalesce
        across an intervening dependency.

        Eligibility reads the conflict keys precomputed at plan
        construction (``_skey``/``_dkey``) -- the walk does no per-plan
        set building.  Returns ``(progressed, remaining)`` where
        ``remaining`` counts in-scope (lane-matched, within-limit)
        plans still pending, so the fixpoint loop can stop the moment
        the FIFOs are clear instead of running one more empty round."""
        eng = self.engines[direction]
        limit = None if limits is None else limits[direction]
        blocked_src: Set[Tuple[str, int]] = set()   # (pool_class, block)
        blocked_dst: Set[Tuple[str, int]] = set()
        skipped_min: Optional[int] = None
        batch: List[TransferPlan] = []
        batch_dsts: Set[Tuple[str, int]] = set()
        progressed = False
        remaining = 0

        def flush():
            nonlocal progressed, batch, batch_dsts
            if not batch:
                return
            for p in batch:
                eng._pending.remove(p)
            if skipped_min is not None:
                self.stats.reordered += sum(1 for p in batch
                                            if p.seqno > skipped_min)
            if direction == D2D:
                self._exec_copies(batch)
            elif direction == D2H:
                self._dispatch_gathers(batch)
            else:
                for p in batch:
                    self._exec_swap_in(p)
            progressed = True
            batch, batch_dsts = [], set()

        for plan in list(eng._pending):
            if limit is not None and plan.seqno > limit:
                break                      # FIFO is seqno-ordered
            self.stats.python_launches += 1
            skey, dkey = plan._skey, plan._dkey
            in_lane = lanes is None or plan.lane in lanes
            eligible = in_lane \
                and not (skey & blocked_dst) \
                and not (dkey & (blocked_dst | blocked_src)) \
                and self._deps_settled(plan)
            if not eligible:
                blocked_src |= skey
                blocked_dst |= dkey
                if skipped_min is None:
                    skipped_min = plan.seqno
                if in_lane:
                    remaining += 1
                continue
            if batch and (plan.pool_class != batch[0].pool_class
                          or (skey & batch_dsts) or (dkey & batch_dsts)):
                # depends on a copy already in the batch (or targets the
                # same block): it must not share the batch's snapshot
                flush()
            batch.append(plan)
            batch_dsts |= dkey
        flush()
        return progressed, remaining

    def _deps_settled(self, plan: TransferPlan) -> bool:
        """Launch-strength deps must have left PENDING; complete-
        strength deps must be DONE -- when their gathers have launched
        but the host copies are still deferred, land those copies now
        (the price of resuming an owner whose swap-out never fenced)."""
        for d, e in plan.deps.items():
            if not self.engines[d].launched_through(e):
                return False
        for d, e in plan.fdeps.items():
            eng = self.engines[d]
            if not eng.launched_through(e):
                return False
            if not eng.prefix_done(e):
                self._run_complete({dd: (e if dd == d else -1)
                                    for dd in DIRECTIONS})
        return True

    def _streams(self, pool_class: str):
        get, set_, layered = self._executors[pool_class]
        return get(), set_, layered

    def _exec_copies(self, batch: List[TransferPlan]) -> None:
        from repro_torch.kernels import ops
        src = np.concatenate([p.src for p in batch]).astype(np.int32)
        dst = np.concatenate([p.dst for p in batch]).astype(np.int32)
        streams, set_, layered = self._streams(batch[0].pool_class)
        copy = ops.copy_pool_blocks if layered else ops.block_copy
        set_([copy(s, src, dst) for s in streams])
        self.stats.launches += 1
        self.stats.coalesced += len(batch) - 1
        self.arena.allocator(batch[0].pool_class).note_write(
            [int(b) for b in dst])
        for plan in batch:
            self._release_holds(plan)
            self._clear_flags(plan)
            plan.state = DONE
            plan.dispatch_mark = self._compute_marks
            self.stats.completed[D2D] += 1
            self.stats.bytes_moved[D2D] += plan.nbytes
            self._notify(plan)

    def _dispatch_gathers(self, batch: List[TransferPlan]) -> None:
        """Launch ONE device gather over the batch's concatenated ids
        (multi-plan), slice per plan and start each slice's asynchronous
        copy to pinned host memory; waiting for the copies is left to
        the fence.  Holds release here: the gather has copied the
        blocks out (stream-ordered before any later write), so the ids
        are safely reusable."""
        from repro_torch.kernels import ops
        ids = np.concatenate([p.src for p in batch]).astype(np.int32)
        streams, _, layered = self._streams(batch[0].pool_class)
        gathered = [ops.gather_blocks(s, ids) if layered
                    else s[torch.as_tensor(ids, device=s.device).long()]
                    for s in streams]
        self.stats.launches += 1
        self.stats.coalesced += len(batch) - 1
        off = 0
        for plan in batch:
            n = plan.src.size
            plan._gathered = _HostCopy([(g[:, off:off + n] if layered
                                         else g[off:off + n])
                                        for g in gathered])
            off += n
            self._release_holds(plan)
            plan.state = DISPATCHED
            plan.dispatch_mark = self._compute_marks
            self.engines[D2H]._dispatched.append(plan)

    def _run_complete(self, limits: Optional[Dict[str, int]] = None) -> None:
        eng = self.engines[D2H]
        limit = None if limits is None else limits.get(D2H, eng.epoch)
        for plan in [p for p in eng._dispatched
                     if limit is None or p.seqno <= limit]:
            eng._dispatched.remove(plan)
            self._complete(plan)

    def _complete(self, plan: TransferPlan) -> None:
        host = plan._gathered.wait()
        plan._gathered = None
        plan.nbytes = int(sum(_nbytes(h) for h in host))
        self.arena.host_deposit(plan.pool_class, plan.owner, host,
                                plan.nbytes)
        plan.state = DONE
        self.stats.launches += 1                 # the host copy itself
        self.stats.completed[D2H] += 1
        self.stats.bytes_moved[D2H] += plan.nbytes
        if self._compute_marks > plan.dispatch_mark:
            self.stats.overlapped[D2H] += 1      # a decode ran in between
        self._notify(plan)

    def _exec_swap_in(self, plan: TransferPlan) -> None:
        from repro_torch.kernels import ops
        cls, owner = plan.pool_class, plan.owner
        if not self.arena.host_contains(cls, owner):
            # belt-and-suspenders behind the fdep mechanism: the payload
            # is still in a dispatched d2h of the same owner (preempt +
            # immediate resume): land it first, in FIFO order
            d2h = self.engines[D2H]
            for p in [p for p in d2h._dispatched
                      if p.pool_class == cls and p.owner == owner]:
                d2h._dispatched.remove(p)
                self._complete(p)
        payload = (self.arena.host_peek(cls, owner) if plan.speculative
                   else self.arena.host_take(cls, owner))
        idx = np.asarray(plan.dst, np.int32)
        streams, set_, layered = self._streams(cls)
        if len(payload) != len(streams):
            raise ValueError(
                f"swap-in of {owner!r}: payload has {len(payload)} "
                f"streams, executor exposes {len(streams)}")
        n = int(plan.dst.size)
        for h in payload:
            saved = (h.shape[1] if layered else h.shape[0]) \
                if h is not None else n
            if saved != n:
                raise ValueError(
                    f"swap-in of {owner!r}: {saved} saved blocks into "
                    f"{n} fresh ids")
        out = []
        for s, h in zip(streams, payload):
            if h is None:
                out.append(s)
                continue
            # nothing here waits for this upload: h is a pinned buffer of
            # the caching host allocator (``_HostCopy``), which keeps it
            # until the copy has run, even once the payload is dropped
            dev = h.to(s.device, non_blocking=True)
            if layered:
                out.append(ops.scatter_blocks(s, idx, dev))
            else:
                s[torch.as_tensor(idx, device=s.device).long()] = dev
                out.append(s)
        set_(out)
        self.arena.allocator(cls).note_write([int(b) for b in idx])
        plan.nbytes = int(sum(_nbytes(h) for h in payload if h is not None))
        self._clear_flags(plan)
        plan.state = DONE
        plan.dispatch_mark = self._compute_marks
        self.stats.launches += 1
        self.stats.completed[H2D] += 1
        self.stats.bytes_moved[H2D] += plan.nbytes
        if plan.speculative:
            self.stats.prefetch_completed += 1
        self._notify(plan)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _HostCopy:
    """The host half of a dispatched gather: per-stream payload slices
    on their way to the host tier.  On a CUDA device the copies go to
    pinned host memory without blocking and ``wait()`` synchronises on
    the event recorded after them -- the fence of the two-phase d2h.
    A payload already on the CPU is the host copy itself."""

    __slots__ = ("host", "event")

    def __init__(self, slices: List[torch.Tensor]):
        self.event = None
        if slices and slices[0].device.type == "cuda":
            self.host = []
            for g in slices:
                h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                h.copy_(g, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(slices)

    def wait(self) -> Tuple[torch.Tensor, ...]:
        if self.event is not None:
            self.event.synchronize()
        return tuple(self.host)


#: the front-end under its producer-facing name
TransferQueue = QueueSet
