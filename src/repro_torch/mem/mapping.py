"""Mapping: one logical object's software page table over Arena leases.

A ``Mapping`` subsumes the repo's ad-hoc block tables: the flat
per-sequence tables of the paged KV cache (``kind="flat"``) and the
radix leaf tables of ``TreeArray`` (``kind="radix"``).  It holds an
ordered list of ``Lease`` handles -- logical block ``i`` of the object
lives in physical block ``leases[i].block`` -- and exposes exactly three
mutation verbs beyond growth:

  * ``fork(owner, nblocks)``    -- COW-share a prefix into a new Mapping
    (paper Table 1 row 'Copy-on-Write': aliasing, not copying);
  * ``ensure_writable(idx)``    -- the COW write barrier: trade a shared
    lease for an exclusive one, returning the (src, dst) physical copy
    the caller must DMA (``kernels/block_copy``);
  * ``migrate(to)``             -- move the whole object between the
    device pool and the host swap tier (Table 1 rows 'Swapping' and
    'Relocation': the new device blocks after a round trip need not
    match the old ones -- the Mapping absorbs relocation).

Growth (``ensure_capacity``) and the write barrier allocate *under
pressure*: when the pool is exhausted the Arena consults its registered
reclaimer (the serving engine's LIFO preemption) instead of failing, and
raises ``LeaseRevokedError`` only when the requester itself had to be
reclaimed.  That policy used to live inline in ``serve/engine.py``; it
is Arena-level now so every client shares it.

Since the transfer-plane redesign the mutation verbs are *plan
producers*: ``migrate`` and ``ensure_writable`` no longer expect the
caller to move payloads -- they enqueue ``TransferPlan``s onto the
Arena's ``TransferQueue`` (``mem/transfer.py``) and the engine's step
loop dispatches/fences them.  ``assert_settled`` is the read barrier:
building a device table over a block whose transfer is unfenced raises
``UnfencedReadError``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

from repro_torch.mem.blockpool import NULL_BLOCK
from repro_torch.mem.lease import Lease
from repro_torch.mem.transfer import D2H, DONE, PENDING, URGENT, UnfencedReadError

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.mem.arena import Arena

FLAT = "flat"
RADIX = "radix"

DEVICE = "device"
HOST = "host"


class Mapping:
    """Ordered leases for one logical object (see module docstring)."""

    __slots__ = ("arena", "pool_class", "owner", "kind", "tenant",
                 "leases", "placement", "_host_blocks", "freed", "_spec",
                 "_spec_plan")

    def __init__(self, arena: "Arena", pool_class: str, owner,
                 kind: str = FLAT, tenant: str = "default"):
        if kind not in (FLAT, RADIX):
            raise ValueError(f"unknown mapping kind {kind!r}")
        self.arena = arena
        self.pool_class = pool_class
        self.owner = owner
        self.kind = kind
        #: quota-accounting tag: whose budget this object's blocks bill
        self.tenant = tenant
        self.leases: List[Lease] = []
        self.placement = DEVICE
        self._host_blocks = 0
        self.freed = False
        # speculative swap-in (prefetch): fresh device leases + their
        # background h2d plan, parked until commit_prefetch/cancel
        self._spec: List[Lease] = []
        self._spec_plan = None

    # -- views -----------------------------------------------------------
    def __len__(self) -> int:
        return (len(self.leases) if self.placement == DEVICE
                else self._host_blocks)

    def block_ids(self) -> List[int]:
        return [l.block for l in self.leases]

    def packed_table(self, capacity: int) -> np.ndarray:
        """NULL-padded flat device table (the per-sequence 'page table')."""
        t = np.full(capacity, NULL_BLOCK, np.int32)
        ids = self.block_ids()
        t[: len(ids)] = ids
        return t

    def assert_settled(self) -> None:
        """Read barrier: every lease's payload must be fenced.

        The engine calls this when it builds the decode tables (after
        ``TransferQueue.dispatch``); an ``in_flight`` lease here means a
        transfer targeting the block was never fenced and the decode
        would read garbage.
        """
        stale = [l.block for l in self.leases if l.in_flight]
        if stale:
            raise UnfencedReadError(
                f"mapping {self.owner!r} ({self.pool_class!r}): blocks "
                f"{stale} are targets of unfenced transfers (per-engine "
                f"queue depths "
                f"{self.arena.transfers.pending_by_direction()}); "
                f"dispatch/drain the arena's transfer queues before "
                f"reading")

    def locality(self) -> float:
        """Fraction of logically-adjacent block pairs that are physically
        adjacent -- the gather-locality half of the fragmentation story
        (``ArenaStats.table_locality`` aggregates this over mappings)."""
        ids = self.block_ids()
        if len(ids) < 2:
            return 1.0
        adj = sum(1 for a, b in zip(ids, ids[1:]) if b == a + 1)
        return adj / (len(ids) - 1)

    # -- growth ----------------------------------------------------------
    def append_blocks(self, n: int, *, pressure: bool = False) -> List[int]:
        """Append ``n`` fresh exclusive leases; returns their block ids."""
        if self.placement != DEVICE:
            raise ValueError(f"append to {self.placement}-resident mapping")
        fresh = self.arena.lease_blocks(self.pool_class, self.owner, n,
                                        pressure=pressure)
        self.leases.extend(fresh)
        return [l.block for l in fresh]

    def ensure_capacity(self, nblocks: int) -> List[int]:
        """Grow to at least ``nblocks`` blocks (under pressure); returns
        the newly added ids.  Atomic: on allocation failure the mapping
        is unchanged."""
        return self.append_blocks(max(0, nblocks - len(self.leases)),
                                  pressure=True)

    def pop_block(self) -> None:
        """Release the trailing lease (BlockStack unlink path)."""
        self.leases.pop().release()

    # -- the three mutation verbs ---------------------------------------
    def fork(self, owner, nblocks: int,
             tenant: Optional[str] = None) -> "Mapping":
        """COW: a new mapping aliasing this one's first ``nblocks`` blocks.

        Pure refcount traffic -- no allocation, so it cannot hit pool
        pressure; the deferred cost surfaces later at the write barrier.
        The child bills ``tenant`` (default: the parent's) -- shared
        blocks are double-billed by design, like refcounts.
        """
        if self.placement != DEVICE:
            raise ValueError("fork of a host-resident mapping")
        if nblocks > len(self.leases):
            raise ValueError(
                f"fork of {nblocks} blocks, parent holds {len(self.leases)}")
        child = self.arena.mapping(self.pool_class, owner, kind=self.kind,
                                   tenant=self.tenant if tenant is None
                                   else tenant)
        for l in self.leases[:nblocks]:
            child.leases.append(l.share(owner))
        return child

    def ensure_writable(self, idx: int) -> Optional[Tuple[int, int]]:
        """COW write barrier for logical block ``idx``.

        When the block is shared this trades the shared lease for an
        exclusive one and ENQUEUES the fulfilment copy on the Arena's
        ``TransferQueue`` (the fresh lease stays ``in_flight`` until the
        plan executes); returns the ``(src, dst)`` pair for callers that
        track copy traffic, or None when the block is already exclusive.
        Allocates the copy target under pressure (this is the deferred
        claim admission cannot reserve -- see ``serve/engine.py``); on
        ``LeaseRevokedError`` the mapping has already been migrated out
        by the reclaimer.
        """
        lease = self.leases[idx]
        if not lease.shared:
            return None
        [fresh] = self.arena.lease_blocks(self.pool_class, self.owner, 1,
                                          pressure=True)
        if not lease.shared:
            # pressure reclaim evicted the last co-sharer mid-alloc:
            # the block is exclusive now, no copy needed
            fresh.release()
            return None
        self.leases[idx] = fresh
        lease.release()
        self.arena.transfers.enqueue_copy(self.pool_class, [lease.block],
                                          [fresh.block], kind="cow")
        # dirty tracking: the divergent write that motivated this barrier
        # lands in the fresh block right after the copy
        self.arena.allocator(self.pool_class).note_write([fresh.block])
        return lease.block, fresh.block

    def migrate(self, to: str) -> List[int]:
        """Move the object device<->host -- as a transfer-plane producer.

        ``to="host"``: release every device lease, register host
        residency and ENQUEUE the swap-out plan (gather + host copy) on
        the Arena's ``TransferQueue``; returns the vacated ids.  The ids
        stay HELD in the allocator until the gather is dispatched, so
        reuse cannot clobber the payload mid-flight.

        ``to="device"``: reallocate (anywhere!), ENQUEUE the swap-in
        scatter into the fresh ids (leases stay ``in_flight`` until it
        executes) and return the new ids -- block tables absorb the
        relocation.
        """
        if to == HOST:
            if self.placement != DEVICE:
                raise ValueError("already host-resident")
            ids = self.block_ids()
            for l in self.leases:
                l.release()
            self.leases = []
            self._host_blocks = len(ids)
            self.placement = HOST
            self.arena._host_register(self.pool_class, self.owner, len(ids))
            self.arena.transfers.enqueue_swap_out(self.pool_class,
                                                  self.owner, ids)
            return ids
        if to == DEVICE:
            if self.placement != HOST:
                raise ValueError("already device-resident")
            if self._spec:
                # a speculative prefetch already reallocated and (maybe)
                # scattered the payload: the resume just commits it
                return self.commit_prefetch()[0]
            n = self.arena._host_unregister(self.pool_class, self.owner)
            self.leases = self.arena.lease_blocks(self.pool_class,
                                                  self.owner, n)
            self._host_blocks = 0
            self.placement = DEVICE
            self.arena.transfers.enqueue_swap_in(self.pool_class,
                                                 self.owner,
                                                 self.block_ids())
            return self.block_ids()
        raise ValueError(f"unknown placement {to!r}")

    # -- speculative swap-in (prefetch) ---------------------------------
    @property
    def prefetched(self) -> bool:
        """A speculative swap-in is parked on this mapping (its blocks
        are on device -- or in flight -- but the resume has not been
        committed; host residency and payload are still intact)."""
        return bool(self._spec)

    @property
    def spec_blocks(self) -> int:
        """Device blocks held by the uncommitted prefetch (0 if none)."""
        return len(self._spec)

    def prefetch(self) -> List[int]:
        """Speculative swap-in: allocate fresh device leases and enqueue
        the h2d scatter on the BACKGROUND lane, while host residency and
        the payload stay intact until ``commit_prefetch``.

        This is the multi-queue plane's hedge: the serving engine
        prefetches the scheduler's LIFO resume candidate while decode
        runs, so a later resume skips the synchronous swap-in entirely.
        Never allocates under pressure (speculation must not evict
        anyone -- the caller checks headroom and the Arena reclaimer
        cancels speculation first when memory tightens).
        """
        if self.placement != HOST:
            raise ValueError("prefetch of a device-resident mapping")
        if self._spec:
            raise ValueError(f"{self.owner!r} already prefetched")
        if self._host_blocks == 0:
            raise ValueError("prefetch of an empty mapping")
        self._spec = self.arena.lease_blocks(self.pool_class, self.owner,
                                             self._host_blocks)
        ids = [l.block for l in self._spec]
        self._spec_plan = self.arena.transfers.enqueue_prefetch(
            self.pool_class, self.owner, ids)
        return ids

    def commit_prefetch(self) -> Tuple[List[int], bool]:
        """Promote the speculative swap-in to the real resume: the spec
        leases become the mapping's table, host residency tears down,
        and -- when the scatter has not executed yet -- the plan leaves
        the background lane to run as a normal swap-in at the next
        dispatch.  Returns ``(new_ids, was_completed)``; ``True`` means
        the resume was served entirely from the completed prefetch (the
        acceptance metric ``prefetch_hit``)."""
        if not self._spec:
            raise ValueError(f"{self.owner!r} has no prefetch to commit")
        plan = self._spec_plan
        completed = plan.state == DONE
        self.leases = self._spec
        self._spec = []
        self._spec_plan = None
        self._host_blocks = 0
        self.placement = DEVICE
        self.arena._host_unregister(self.pool_class, self.owner)
        if completed:
            # the scatter only PEEKED the payload; consume it now
            self.arena.host_discard(self.pool_class, self.owner)
        elif plan.state == PENDING:
            plan.lane = URGENT
            plan.speculative = False     # executes as a real swap-in
        self.arena.transfers.note_prefetch_commit(plan)
        return self.block_ids(), completed

    def cancel_prefetch(self) -> None:
        """Withdraw the speculation: drop the plan (if still pending),
        release the fresh leases and leave the mapping exactly as
        preempted -- host residency and payload intact, so a later real
        swap-in still works.  Called when the candidate is freed, or by
        the pressure path (speculative blocks are the FIRST thing
        reclaimed -- cheaper than preempting a running sequence)."""
        if not self._spec:
            raise ValueError(f"{self.owner!r} has no prefetch to cancel")
        plan = self._spec_plan
        if not self.arena.transfers.cancel_plan(plan):
            # the scatter already ran (wasted speculation): the payload
            # was only peeked, so releasing the leases loses nothing --
            # ledgers are re-notified to write the parked bytes off
            self.arena.transfers.note_prefetch_abandon(plan)
        for l in self._spec:
            l.release()
        self._spec = []
        self._spec_plan = None

    # -- teardown --------------------------------------------------------
    def free(self) -> None:
        """Release everything this mapping holds (either placement)."""
        if self.freed:
            raise ValueError(f"double free of mapping {self.owner!r}")
        if self._spec:
            # cancel-while-prefetched: withdraw the speculation first so
            # the spec leases and their pending scatter never outlive
            # the mapping
            self.cancel_prefetch()
        if self.placement == HOST:
            upto = self.arena.transfers.last_transit(self.pool_class,
                                                     self.owner)
            if upto is not None:
                # cancel-while-swapping: land the in-flight payload so
                # residency and payload tear down together -- only the
                # d2h prefix up to our plan (plus its cross-queue
                # dependency closure); later transfers stay overlapped
                self.arena.transfers.drain(upto={D2H: upto})
            self.arena._host_unregister(self.pool_class, self.owner)
            self.arena.host_discard(self.pool_class, self.owner)
        else:
            upto = self.arena.transfers.last_reference(self.pool_class,
                                                       self.block_ids())
            if upto is not None:
                # cancel-while-transferring: a pending plan (swap-in
                # scatter, COW copy) still names these blocks -- settle
                # the prefix through it before the ids return to the
                # free list, or a stale scatter would clobber their
                # next tenant
                self.arena.transfers.drain(upto=upto)
            for l in self.leases:
                l.release()
        self.leases = []
        self.freed = True
        self.arena._forget_mapping(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Mapping({self.pool_class}/{self.owner!r} {self.kind} "
                f"{self.placement} x{len(self)})")
