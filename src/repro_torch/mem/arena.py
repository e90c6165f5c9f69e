"""Arena: ONE software address space behind every block-backed subsystem.

The paper's central bet is that a single, simple software memory manager
-- fixed blocks, id-based page tables, no contiguity promises -- can
serve every client an OS with virtual memory would.  This class is that
manager as one artifact: the paged KV cache, ``TreeArray``,
``BlockStack`` and the serving host store all allocate here, so an
experiment can measure "the allocator" instead of five re-implementations
of it.

Shape of the API:

  * one **pool class** per (block_shape, dtype) family -- the paper's
    "choose your own block quantum" argument: KV blocks, tree leaves and
    host-side metadata blocks coexist as separately sized classes of the
    same address space, each backed by a ``BlockAllocator``;
  * the **host swap tier** is a first-class second placement level, not
    a side table: a ``Mapping`` migrated to host keeps its identity (and
    its payload, deposited by the transfer layer) and re-materializes on
    any free device blocks later;
  * clients hold typed ``Lease`` handles and ``Mapping`` tables, never
    raw ints, so compaction can relocate physical blocks without any
    client seeing a stale id;
  * allocation **under pressure** consults a registered *reclaimer*
    (the serving engine's LIFO preemption) instead of failing -- the COW
    barrier and growth fallback that used to live inline in
    ``serve/engine.py`` are Arena policy now, and the scheduler
    negotiates admission against ``free_blocks`` of this one arena;
  * ``compact()`` is the defrag pass: when free blocks are
    plentiful but table locality has degraded, it emits a
    relocation plan moving live blocks to a dense prefix and
    rewrites every lease in place (paper Table 1 row 'Relocation /
    Migration': tables absorb the move, no client pointer updates);
  * every payload move -- migrate, swap, COW fulfilment, compaction --
    is a **plan on the arena's ``TransferQueue``** (``mem/transfer.py``):
    enqueue now, dispatch/fence when the consumer schedules it.  The
    queue holds vacated DMA sources in the allocator and flags copy
    targets ``in_flight`` until fenced, so the discipline is provable
    (``assert_quiescent`` requires an empty queue);
  * the host tier holds payloads as CPU tensors (pinned when the pools
    live on a CUDA device), because numpy has no bfloat16;
  * ``snapshot()``/``restore()`` checkpoint the survivable state -- the
    host tier, every mapping's table and, for live migration, the device
    payload -- to one ``.npz`` in the reference package's schema: a
    ``__meta__`` JSON, every stream as raw ``uint8`` bytes beside its
    shape and dtype name (``"bfloat16"``, ``"float32"``), so a snapshot
    written by either package restores into the other.
"""

from __future__ import annotations

import collections
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.mem.blockpool import BlockAllocator, OutOfBlocksError
from repro_torch.mem.lease import Lease
from repro_torch.mem.mapping import DEVICE, FLAT, HOST, Mapping
from repro_torch.mem.stats import ArenaStats, PoolClassStats
from repro_torch.mem.transfer import QueueSet

#: reclaimer signature: called with the requesting owner when a pool
#: class is exhausted; must free blocks (e.g. preempt a victim) and
#: return the reclaimed owner, or None when nothing can be reclaimed.
Reclaimer = Callable[[object], Optional[object]]


class LeaseRevokedError(OutOfBlocksError):
    """Pressure reclaim chose the requester itself: its blocks were
    migrated out mid-request, so the allocation is moot.  Subclasses
    ``OutOfBlocksError`` so legacy callers that catch the base class
    keep working."""


class _PoolClass:
    """Internal per-(block_shape, dtype) state."""

    __slots__ = ("name", "num_blocks", "block_shape", "dtype",
                 "block_nbytes", "allocator", "leases", "pinned",
                 "mappings", "dp_groups", "quota_by_tenant")

    def __init__(self, name: str, num_blocks: int, block_shape: Tuple,
                 dtype, block_nbytes: int, dp_groups: int = 1):
        self.name = name
        self.num_blocks = num_blocks
        self.block_shape = block_shape
        self.dtype = dtype
        self.block_nbytes = block_nbytes
        self.dp_groups = dp_groups
        self.allocator = BlockAllocator(num_blocks)
        self.leases: Dict[int, List[Lease]] = {}
        self.pinned: List[Lease] = []
        self.mappings: List[Mapping] = []
        #: per-tenant block ceilings enforced at ADMISSION (scheduler
        #: policy), not at allocation -- an admitted sequence may always
        #: grow to the footprint it was admitted under
        self.quota_by_tenant: Dict[str, int] = {}

    def group_range(self, g: int) -> Tuple[int, int]:
        """Contiguous id range of dp pool group ``g`` (co-sharded with
        the pool's block dim -- see ``PagedKVConfig.dp_groups``)."""
        per = self.num_blocks // self.dp_groups
        lo = g * per
        hi = (g + 1) * per if g < self.dp_groups - 1 else self.num_blocks
        return lo, hi


class Arena:
    """The unified software address space (see module docstring)."""

    def __init__(self):
        self._classes: Dict[str, _PoolClass] = {}
        self._reclaimer: Optional[Reclaimer] = None
        # per-pool-class reclaimers (heterogeneous serving: each
        # engine handles pressure for ITS classes); the global
        # reclaimer stays the single-engine default.
        self._reclaimers: Dict[str, Reclaimer] = {}
        # host tier: residency counts (owned by Mapping.migrate) and
        # payloads (deposited/taken by the transfer plane) are separate
        # so migrate("device") can reallocate ids before the scatter.
        self._host_counts: Dict[Tuple[str, object], int] = {}
        self._host_payload: Dict[Tuple[str, object], Tuple[object, int]] = {}
        #: the asynchronous transfer plane: every payload move (swap,
        #: COW copy, compaction, migrate) is a plan enqueued here --
        #: one TransferEngine per direction behind a QueueSet front-end.
        self.transfers = QueueSet(self)
        self.compactions = 0
        self.blocks_compacted = 0

    # ---------------- pool classes ----------------
    def register_class(self, name: str, *, num_blocks: int,
                       block_shape: Tuple = (), dtype=torch.float32,
                       block_nbytes: Optional[int] = None,
                       dp_groups: int = 1,
                       quota_by_tenant: Optional[Dict[str, int]] = None
                       ) -> str:
        """Declare (or re-attach to) one (block_shape, dtype) pool class.

        Registration is idempotent for an identical spec -- many clients
        of one engine attach to the same class -- and loud on conflict.
        ``dp_groups`` partitions the id space into contiguous ranges for
        per-group accounting (``ArenaStats`` reports blocks held/free
        per group).  ``quota_by_tenant`` sets per-tenant block ceilings
        enforced at admission time; it is operator-updatable metadata,
        not part of the conflict-checked spec (re-registering with a new
        quota replaces it).  Returns ``name`` so callers can chain.
        """
        if block_nbytes is None:
            block_nbytes = (int(np.prod(block_shape)) if block_shape else 1
                            ) * torch.empty((), dtype=dtype).element_size()
        if name in self._classes:
            st = self._classes[name]
            if (st.num_blocks != num_blocks
                    or st.block_nbytes != block_nbytes
                    or st.block_shape != tuple(block_shape)
                    or st.dtype != dtype
                    or st.dp_groups != dp_groups):
                raise ValueError(
                    f"pool class {name!r} re-registered with a different "
                    f"spec: {num_blocks}x{block_nbytes}B "
                    f"{tuple(block_shape)}/{dtype}/g{dp_groups} vs existing "
                    f"{st.num_blocks}x{st.block_nbytes}B "
                    f"{st.block_shape}/{st.dtype}/g{st.dp_groups}")
            if quota_by_tenant is not None:
                st.quota_by_tenant = dict(quota_by_tenant)
            return name
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if dp_groups < 1 or dp_groups > num_blocks:
            raise ValueError(f"dp_groups must be in [1, num_blocks], "
                             f"got {dp_groups}")
        st = _PoolClass(name, num_blocks, tuple(block_shape),
                        dtype, int(block_nbytes), int(dp_groups))
        if quota_by_tenant is not None:
            st.quota_by_tenant = dict(quota_by_tenant)
        self._classes[name] = st
        return name

    def _cls(self, name: str) -> _PoolClass:
        try:
            return self._classes[name]
        except KeyError:
            raise KeyError(f"unregistered pool class {name!r}; call "
                           f"Arena.register_class first") from None

    @property
    def pool_classes(self) -> List[str]:
        return list(self._classes)

    # ---------------- queries ----------------
    def num_blocks(self, cls: str) -> int:
        return self._cls(cls).num_blocks

    def num_free(self, cls: str) -> int:
        return self._cls(cls).allocator.num_free

    def num_used(self, cls: str) -> int:
        return self._cls(cls).allocator.num_used

    def refcount(self, cls: str, block: int) -> int:
        return self._cls(cls).allocator.refcount(block)

    def block_nbytes(self, cls: str) -> int:
        return self._cls(cls).block_nbytes

    def tenant_quota(self, cls: str, tenant: str) -> Optional[int]:
        """The tenant's block ceiling in ``cls`` (None = unlimited)."""
        return self._cls(cls).quota_by_tenant.get(str(tenant))

    def blocks_by_tenant(self, cls: str) -> Dict[str, int]:
        """Blocks currently charged to each tenant in ``cls``: device
        leases plus host-tier residency of every tenant-tagged mapping.
        Untagged allocations (pinned sinks, raw leases) are unbilled."""
        out: collections.Counter = collections.Counter()
        for m in self._cls(cls).mappings:
            if m.placement == HOST:
                out[str(m.tenant)] += int(m._host_blocks)
            else:
                out[str(m.tenant)] += len(m.leases)
        return dict(out)

    def find_mapping(self, cls: str, owner) -> Optional[Mapping]:
        """The live mapping of ``owner`` in ``cls``, if any (used by the
        engine to adopt restored mappings)."""
        for m in self._cls(cls).mappings:
            if m.owner == owner:
                return m
        return None

    def allocator(self, cls: str) -> BlockAllocator:
        """The raw allocator -- a compat escape hatch for tests that poke
        free-list state.  Blocks allocated here bypass the lease registry
        and make the class ineligible for ``compact()``."""
        return self._cls(cls).allocator

    # ---------------- pressure protocol ----------------
    def set_reclaimer(self, fn: Optional[Reclaimer],
                      pool_class: Optional[str] = None) -> None:
        """Register the pressure-time reclaim callback.

        With ``pool_class`` the reclaimer handles exhaustion of THAT
        class only -- the heterogeneous-serving shape, where each engine
        owns pressure for its own pool classes and many engines share
        one address space.  Without it, the callback is the arena-wide
        default (single-engine shape).  Either way exactly one reclaimer
        per scope: silently displacing an earlier registrant would
        reroute its pressure handling, so that conflict is loud.  Pass
        None to clear before handing the scope to a new owner.
        """
        if pool_class is not None:
            prev = self._reclaimers.get(pool_class)
            if fn is not None and prev is not None and prev is not fn:
                raise ValueError(
                    f"pool class {pool_class!r} already has a reclaimer "
                    f"registered; call set_reclaimer(None, "
                    f"pool_class={pool_class!r}) first")
            if fn is None:
                self._reclaimers.pop(pool_class, None)
            else:
                self._reclaimers[pool_class] = fn
            return
        if (fn is not None and self._reclaimer is not None
                and self._reclaimer is not fn):
            raise ValueError(
                "arena already has a reclaimer registered; call "
                "set_reclaimer(None) first to transfer ownership")
        self._reclaimer = fn

    def _alloc_ids(self, cls: str, n: int, *, pressure: bool,
                   requester) -> List[int]:
        """Atomically allocate ``n`` ids, reclaiming under pressure.

        This loop is the LIFO-preemption fallback that used to live in
        ``serve/engine.py``: on exhaustion the reclaimer evicts victims
        (newest admission first) until the request fits -- or until the
        requester itself is the victim, which surfaces as
        ``LeaseRevokedError`` (the requester's blocks are already on the
        host tier; the allocation is moot, not failed).
        """
        st = self._cls(cls)
        reclaimer = self._reclaimers.get(cls, self._reclaimer)
        while True:
            if st.allocator.num_free >= n:
                return [st.allocator.alloc() for _ in range(n)]
            if self.transfers.has_undispatched:
                # undispatched plans hold vacated blocks; DISPATCH
                # releases the holds without blocking on host copies
                # (those stay overlapped), so pressure-path allocation
                # never degenerates to the synchronous schedule
                self.transfers.dispatch()
                continue
            if not pressure or reclaimer is None:
                raise OutOfBlocksError(
                    f"pool class {cls!r}: requested {n} blocks, "
                    f"only {st.allocator.num_free} free")
            victim = reclaimer(requester)
            if victim is None:
                raise OutOfBlocksError(
                    f"pool class {cls!r}: exhausted and nothing left "
                    f"to reclaim")
            if victim == requester:
                raise LeaseRevokedError(
                    f"pool class {cls!r}: owner {requester!r} was "
                    f"reclaimed to satisfy its own request")

    # ---------------- leases ----------------
    def lease_blocks(self, cls: str, owner, n: int = 1, *,
                     pressure: bool = False,
                     requester=None) -> List[Lease]:
        """Allocate ``n`` exclusive leases for ``owner``."""
        ids = self._alloc_ids(cls, n, pressure=pressure,
                              requester=owner if requester is None
                              else requester)
        st = self._cls(cls)
        out = []
        for b in ids:
            lease = Lease(self, cls, b, owner)
            st.leases.setdefault(b, []).append(lease)
            out.append(lease)
        return out

    def share(self, lease: Lease, owner) -> Lease:
        """COW-alias: a new lease on the same block (refcount++)."""
        if not lease.live:
            raise ValueError("share of a released lease")
        if lease.pinned:
            raise ValueError("pinned blocks cannot be shared")
        st = self._cls(lease.pool_class)
        st.allocator.share(lease.block)
        new = Lease(self, lease.pool_class, lease.block, owner)
        st.leases[lease.block].append(new)
        return new

    def release(self, lease: Lease) -> None:
        if not lease.live:
            raise ValueError(f"double release of {lease!r}")
        lease.live = False
        st = self._cls(lease.pool_class)
        holders = st.leases[lease.block]
        holders.remove(lease)
        if not holders:
            del st.leases[lease.block]
        st.allocator.free(lease.block)

    def pin(self, cls: str, owner="pinned") -> Lease:
        """Permanently claim one block (e.g. the engine's write sink:
        masked table entries scatter here instead of into live blocks).
        Pinned blocks survive ``assert_quiescent`` and may still be
        relocated by ``compact()`` -- holders read ``lease.block``."""
        [lease] = self.lease_blocks(cls, owner)
        lease.pinned = True
        self._cls(cls).pinned.append(lease)
        return lease

    def unpin(self, lease: Lease) -> None:
        self._cls(lease.pool_class).pinned.remove(lease)
        lease.pinned = False
        self.release(lease)

    # ---------------- mappings ----------------
    def mapping(self, cls: str, owner, kind: str = FLAT,
                tenant: str = "default") -> Mapping:
        m = Mapping(self, cls, owner, kind=kind, tenant=tenant)
        self._cls(cls).mappings.append(m)
        return m

    def _forget_mapping(self, m: Mapping) -> None:
        self._cls(m.pool_class).mappings.remove(m)

    # ---------------- host swap tier ----------------
    def _host_register(self, cls: str, owner, nblocks: int) -> None:
        key = (cls, owner)
        if key in self._host_counts:
            raise ValueError(f"{owner!r} already host-resident in {cls!r}")
        self._host_counts[key] = nblocks

    def _host_unregister(self, cls: str, owner) -> int:
        return self._host_counts.pop((cls, owner))

    def host_deposit(self, cls: str, owner, payload, nbytes: int) -> None:
        """Attach a migrated mapping's payload (one compact gathered
        array per stream -- see ``serve/swap.py``)."""
        self._host_payload[(cls, owner)] = (payload, int(nbytes))

    def host_take(self, cls: str, owner):
        payload, _ = self._host_payload.pop((cls, owner))
        return payload

    def host_peek(self, cls: str, owner):
        """Read a payload WITHOUT consuming it -- the speculative
        swap-in path: a prefetch scatters the payload to device but the
        host copy stays authoritative until ``commit_prefetch`` (so a
        cancelled prefetch costs nothing to undo)."""
        payload, _ = self._host_payload[(cls, owner)]
        return payload

    def host_discard(self, cls: str, owner) -> None:
        self._host_payload.pop((cls, owner), None)

    def host_contains(self, cls: str, owner) -> bool:
        return (cls, owner) in self._host_payload

    def host_len(self, cls: str) -> int:
        return sum(1 for (c, _) in self._host_payload if c == cls)

    def host_counts(self, cls: str) -> Dict[object, int]:
        return {o: n for (c, o), n in self._host_counts.items() if c == cls}

    # ---------------- fragmentation / compaction ----------------
    def fragmentation(self, cls: str) -> float:
        """1 - used/span over the id space; 0.0 = dense prefix.

        With fixed blocks there is no *external* fragmentation (the
        paper's point) -- this measures how far live blocks have
        scattered from the dense prefix, which is what degrades
        table-gather locality and what ``compact()`` restores.
        """
        st = self._cls(cls)
        used = st.allocator.num_used
        if used == 0:
            return 0.0
        span = int(st.allocator.used_ids().max()) + 1
        return 1.0 - used / span

    def table_locality(self, cls: str) -> float:
        """Mean ``Mapping.locality()`` over device-resident mappings."""
        vals = [m.locality() for m in self._cls(cls).mappings
                if m.placement == DEVICE and len(m.leases) >= 2]
        return float(np.mean(vals)) if vals else 1.0

    def should_compact(self, cls: str, *, min_free_frac: float = 0.25,
                       frag_threshold: float = 0.25) -> bool:
        """Defrag policy: free blocks are plentiful (the copy plan is
        cheap and nothing is starving) but locality has degraded."""
        st = self._cls(cls)
        if st.allocator.num_free < min_free_frac * st.num_blocks:
            return False
        return self.fragmentation(cls) > frag_threshold

    def compact(self, cls: str) -> Tuple[np.ndarray, np.ndarray]:
        """Move live blocks to the dense prefix; the (src, dst) copy
        plan is ENQUEUED on the arena's ``TransferQueue`` (the moved
        leases stay ``in_flight`` and the vacated sources HELD until the
        consumer dispatches it) and also returned for accounting.

        Compaction is a fence point: pending transfers are drained first
        so the relocation plan sees settled block contents and no held
        ids.  Every lease is rewritten in place (tables built afterwards
        see only new ids) and the allocator's free list is rebuilt.
        Refuses to run when any live block is not lease-tracked
        (raw-allocator escape hatch in use) -- relocating a block
        nobody's table names would lose data silently.
        """
        self.transfers.drain()
        st = self._cls(cls)
        live = [int(b) for b in st.allocator.used_ids()]
        untracked = [b for b in live if b not in st.leases]
        if untracked:
            raise RuntimeError(
                f"cannot compact {cls!r}: blocks {untracked} were "
                f"allocated outside the lease registry")
        from repro_torch.core.block_table import compaction_plan
        plan = compaction_plan(live)
        if not plan:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        st.allocator.relocate(plan)
        for s, d in plan:
            moved = st.leases.pop(s)
            for lease in moved:
                lease.block = d
            st.leases[d] = moved
        self.compactions += 1
        self.blocks_compacted += len(plan)
        src = np.asarray([s for s, _ in plan], np.int32)
        dst = np.asarray([d for _, d in plan], np.int32)
        self.transfers.enqueue_copy(cls, src, dst, kind="compact")
        return src, dst

    # ---------------- stats / invariants ----------------
    def stats(self) -> ArenaStats:
        classes = {}
        for name, st in self._classes.items():
            by_owner: collections.Counter = collections.Counter()
            in_flight = 0
            for holders in st.leases.values():
                for lease in holders:
                    by_owner[str(lease.owner)] += 1
                    in_flight += int(lease.in_flight)
            host = {str(o): n for (c, o), n in self._host_counts.items()
                    if c == name}
            kinds: collections.Counter = collections.Counter(
                m.kind for m in st.mappings)
            groups = []
            if st.dp_groups > 1:
                used = set(int(b) for b in st.allocator.used_ids())
                # transfer-plane-held blocks are not allocatable: count
                # them out of 'free' so per-group headroom sums to the
                # class-level num_free even mid-flight
                held_ids = st.allocator.held_ids()
                for g in range(st.dp_groups):
                    lo, hi = st.group_range(g)
                    u = sum(1 for b in used if lo <= b < hi)
                    h = sum(1 for b in held_ids if lo <= b < hi)
                    groups.append({"group": g, "used": u,
                                   "free": (hi - lo) - u - h})
            classes[name] = PoolClassStats(
                name=name,
                num_blocks=st.num_blocks,
                num_free=st.allocator.num_free,
                num_used=st.allocator.num_used,
                pinned=len(st.pinned),
                blocks_by_owner=dict(by_owner),
                host_blocks_by_owner=host,
                refcount_histogram=[int(x) for x in
                                    st.allocator.refcount_histogram()],
                fragmentation=round(self.fragmentation(name), 4),
                table_locality=round(self.table_locality(name), 4),
                mappings_by_kind=dict(kinds),
                in_flight=in_flight,
                held=st.allocator.num_held,
                held_by_engine=st.allocator.held_by_engine(),
                groups=groups,
                quota_by_tenant=dict(st.quota_by_tenant),
                blocks_by_tenant=self.blocks_by_tenant(name),
            )
        return ArenaStats(classes=classes, compactions=self.compactions,
                          blocks_compacted=self.blocks_compacted,
                          transfers=self.transfers.stats.to_dict())

    def check_registry(self, cls: str) -> None:
        """Invariant: every allocated block's refcount equals its lease
        count (no bookkeeping drift between allocator and handles)."""
        st = self._cls(cls)
        for b in st.allocator.used_ids():
            b = int(b)
            n = len(st.leases.get(b, []))
            assert n == st.allocator.refcount(b), (
                f"pool class {cls!r} block {b}: {n} leases vs refcount "
                f"{st.allocator.refcount(b)}")

    def assert_quiescent(self) -> None:
        """Leak invariant: nothing but pinned blocks is allocated, the
        host tier is empty, and the transfer plane is fenced (no pending
        plans, no held blocks).  Every engine test ends on this."""
        assert self.transfers.pending == 0, (
            f"unfenced transfers at quiescence: "
            f"{self.transfers.pending_by_direction()}")
        for name, st in self._classes.items():
            assert st.allocator.num_held == 0, (
                f"pool class {name!r}: {st.allocator.num_held} blocks "
                f"still held by the transfer plane")
            pinned_ids = {l.block for l in st.pinned}
            for b in st.allocator.used_ids():
                b = int(b)
                assert b in pinned_ids, (
                    f"leak in pool class {name!r}: block {b} "
                    f"(refcount {st.allocator.refcount(b)}, leases "
                    f"{st.leases.get(b)}) still allocated")
                assert st.allocator.refcount(b) == 1, (
                    f"pinned block {b} of {name!r} has refcount "
                    f"{st.allocator.refcount(b)} != 1")
            hist = st.allocator.refcount_histogram()
            assert int(hist[1:].sum()) == len(pinned_ids), (
                f"refcount histogram of {name!r} not all-zeros beyond "
                f"pinned: {hist.tolist()}")
        assert not self._host_counts, (
            f"host tier residency leaked: {self._host_counts}")
        assert not self._host_payload, (
            f"host tier payload leaked: {list(self._host_payload)}")

    def check_consistency(self) -> None:
        """Cross-layer invariants over the device registry AND the host
        tier (every allocated block's refcount equals its lease count,
        the lease registry's total mass matches the refcount histogram,
        host-resident mappings agree with registered residency, and
        landed payloads cover exactly the blocks they claim); raises
        ``AssertionError`` on the first drifted counter."""
        for name, st in self._classes.items():
            self.check_registry(name)
            total_leases = sum(len(v) for v in st.leases.values())
            hist = st.allocator.refcount_histogram()
            mass = int(sum(r * int(c) for r, c in enumerate(hist)))
            assert total_leases == mass, (
                f"pool class {name!r}: {total_leases} leases vs refcount "
                f"mass {mass}")
            for m in st.mappings:
                if m.placement != HOST:
                    continue
                key = (name, m.owner)
                assert self._host_counts.get(key) == m._host_blocks, (
                    f"host mapping {m.owner!r} in {name!r}: "
                    f"{m._host_blocks} blocks vs registered "
                    f"{self._host_counts.get(key)}")
        for (cls, owner), n in self._host_counts.items():
            entry = self._host_payload.get((cls, owner))
            if entry is None:
                # residency without a landed payload is only legal while
                # the swap-out is still in transit on the d2h queue (or
                # for metadata-only classes, which never carry payloads)
                assert (not self.transfers.has_executor(cls)
                        or owner in self.transfers.in_transit(cls)), (
                    f"host residency of {owner!r} in {cls!r} has no "
                    f"payload and no in-transit swap-out")
                continue
            if self.transfers.has_executor(cls):
                layered = self.transfers.is_layered(cls)
                for s in entry[0]:
                    if s is None:
                        continue
                    saved = s.shape[1] if layered else s.shape[0]
                    assert saved == n, (
                        f"host payload of {owner!r} in {cls!r} covers "
                        f"{saved} blocks, residency says {n}")

    # ---------------- checkpoint (host tier + mappings) ----------------
    @staticmethod
    def _tag_owner(owner) -> str:
        if isinstance(owner, (bool, float)):
            raise TypeError(f"unsupported owner type for snapshot: "
                            f"{type(owner).__name__}")
        if isinstance(owner, (int, np.integer)):
            return f"i:{int(owner)}"
        if isinstance(owner, str):
            return f"s:{owner}"
        raise TypeError(f"unsupported owner type for snapshot: "
                        f"{type(owner).__name__}")

    @staticmethod
    def _untag_owner(tag: str):
        kind, _, val = tag.partition(":")
        return int(val) if kind == "i" else val

    def _host_tensor(self, cls: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a payload the class's executor may upload without
        waiting: when its pools live on a CUDA device, a pinned buffer of
        PyTorch's caching host allocator, which keeps the memory until a
        queued copy has read it (a tensor over numpy memory has no such
        owner)."""
        if not self.transfers.has_executor(cls) or t.is_pinned():
            return t
        streams, _, _ = self.transfers._streams(cls)
        if streams and streams[0].device.type == "cuda":
            return t.pin_memory()
        return t

    def gather_device_payload(self, cls: str, *, lane=None,
                              kind: str = "migrate-out"):
        """Gather ALL live mapped device blocks of ``cls`` to the host in
        one transfer-plane pass; returns ``(ids, streams, gens)`` or None
        when the class has no device-resident mapping (or no executor --
        metadata-only classes carry no payload).

        The gather is a pure read: live blocks (refcount > 0) take no
        allocator holds, so decode can keep running against them -- the
        building block of both one-shot device snapshots and the
        migration pre-copy rounds (which pass ``lane=BACKGROUND``).
        """
        from repro_torch.mem.transfer import URGENT
        st = self._cls(cls)
        if not self.transfers.has_executor(cls):
            return None
        ids: List[int] = []
        seen = set()
        for m in st.mappings:
            if m.placement != DEVICE:
                continue
            for b in m.block_ids():
                if b not in seen:
                    seen.add(b)
                    ids.append(b)
        if not ids:
            return None
        gens = [st.allocator.write_gen(b) for b in ids]
        owner = f"__snapshot__/{cls}"
        self.transfers.enqueue_swap_out(
            cls, owner, ids, kind=kind,
            lane=URGENT if lane is None else lane)
        self.transfers.drain()
        streams = self.host_take(cls, owner)
        return ids, streams, gens

    def snapshot(self, path: str, *, include_device: bool = False,
                 device_payloads: Optional[Dict[str, tuple]] = None
                 ) -> None:
        """Checkpoint the arena's survivable state to one ``.npz``:
        pool-class specs, host-tier residency + payloads (the swapped
        sequences' KV), and every mapping's table.

        The transfer plane is drained first (in-flight payloads land).
        By default device pool CONTENTS are not captured -- a restart
        loses device memory by definition; the swap tier is exactly the
        state that survives.  ``include_device=True`` is the migration
        path: every executor-backed class's live mapped blocks are
        gathered through the transfer plane and stored alongside the
        mapping tables, preserving COW aliasing exactly (restore
        re-leases one physical block per distinct saved id and re-shares
        it across every mapping that named it).  ``device_payloads``
        lets a ``MigrationSession`` hand over pre-copied payloads
        (``{cls: (ids, streams, gens)}``) so the stop-and-copy pause
        only re-gathers the dirty tail, not the whole pool.
        """
        self.transfers.drain()
        device: Dict[str, tuple] = dict(device_payloads or {})
        if include_device:
            for name in self._classes:
                if name not in device:
                    got = self.gather_device_payload(name)
                    if got is not None:
                        device[name] = got
        # host-tier residency is not serialized separately: each
        # host-resident mapping entry carries its block count, and
        # restore() rebuilds _host_counts from those
        meta: dict = {"classes": {}, "mappings": [], "payloads": [],
                      "device": {}}
        arrays: Dict[str, np.ndarray] = {}

        def put(key: str, t: torch.Tensor) -> dict:
            t = t.detach().contiguous()
            arrays[key] = t.reshape(-1).view(torch.uint8).numpy()
            return {"key": key, "shape": list(t.shape),
                    "dtype": _dtype_name(t.dtype)}

        for name, st in self._classes.items():
            meta["classes"][name] = {
                "num_blocks": st.num_blocks,
                "block_nbytes": st.block_nbytes,
                "block_shape": list(st.block_shape),
                "dtype": _dtype_name(st.dtype),
                "dp_groups": st.dp_groups,
            }
        for name, st in self._classes.items():
            for m in st.mappings:
                meta["mappings"].append({
                    "cls": name, "owner": self._tag_owner(m.owner),
                    "kind": m.kind, "placement": m.placement,
                    "tenant": self._tag_owner(m.tenant),
                    "blocks": ([int(b) for b in m.block_ids()]
                               if m.placement == DEVICE
                               else int(m._host_blocks)),
                })
        for name, (ids, streams, gens) in device.items():
            meta["device"][name] = {
                "blocks": [int(b) for b in ids],
                "gens": [int(g) for g in gens],
                "streams": [None if t is None else put(f"device_{name}_{j}", t)
                            for j, t in enumerate(streams)]}
        for i, ((cls, owner), (payload, nbytes)) in enumerate(
                self._host_payload.items()):
            meta["payloads"].append({
                "cls": cls, "owner": self._tag_owner(owner),
                "nbytes": int(nbytes),
                "streams": [None if t is None else put(f"payload_{i}_{j}", t)
                            for j, t in enumerate(payload)]})
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8)
        np.savez(path, **arrays)

    def restore(self, path: str) -> Dict[Tuple[str, object], Mapping]:
        """Rebuild host-tier residency, payloads and mappings from a
        ``snapshot()`` (of this package or the reference's).

        Pool classes are re-registered when absent (idempotent-or-loud
        when present, so restoring into an engine-built arena verifies
        the specs match).  HOST-resident mappings always come back.
        DEVICE-resident mappings come back when the snapshot carries
        device payloads (``include_device=True`` / a migration
        finalize): each distinct saved block id gets one fresh lease and
        every further mapping that named it re-shares that lease, so
        refcounts and COW aliasing survive the roundtrip exactly; the
        payload is then scattered through the transfer plane onto the
        (relocated) fresh ids -- block tables absorb the move, as
        everywhere else.  Returns ``{(pool_class, owner): Mapping}`` for
        the caller to re-adopt (``PagedKVManager.adopt``).
        """
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())

            def stream(cls: str, s: Optional[dict]):
                if s is None:
                    return None
                raw = z[s["key"]]
                if not raw.flags.writeable:
                    raw = raw.copy()
                t = torch.from_numpy(raw).view(_torch_dtype(s["dtype"]))
                return self._host_tensor(cls, t.reshape(s["shape"]))

            for name, spec in meta["classes"].items():
                self.register_class(
                    name, num_blocks=spec["num_blocks"],
                    block_shape=tuple(spec["block_shape"]),
                    dtype=_torch_dtype(spec["dtype"]),
                    block_nbytes=spec["block_nbytes"],
                    dp_groups=spec.get("dp_groups", 1))
            device_meta = meta.get("device", {})
            restored: Dict[Tuple[str, object], Mapping] = {}
            # old physical id -> the first lease re-materializing it (the
            # COW alias anchor); later mappings share it instead of
            # allocating
            alias: Dict[Tuple[str, int], Lease] = {}
            for entry in meta["mappings"]:
                cls = entry["cls"]
                owner = self._untag_owner(entry["owner"])
                tenant = (self._untag_owner(entry["tenant"])
                          if "tenant" in entry else "default")
                if entry["placement"] == HOST:
                    m = self.mapping(cls, owner, kind=entry["kind"],
                                     tenant=tenant)
                    m.placement = HOST
                    m._host_blocks = int(entry["blocks"])
                    self._host_register(cls, owner, m._host_blocks)
                    restored[(cls, owner)] = m
                    continue
                if cls not in device_meta:
                    # no device payload in the snapshot: a restarted
                    # process lost device memory by definition --
                    # re-submit those requests
                    continue
                if not self.transfers.has_executor(cls):
                    raise RuntimeError(
                        f"snapshot carries device payload for pool class "
                        f"{cls!r} but the restoring arena has no "
                        f"executor; restore into an engine-built arena")
                m = self.mapping(cls, owner, kind=entry["kind"],
                                 tenant=tenant)
                for old in entry["blocks"]:
                    key = (cls, int(old))
                    if key in alias:
                        m.leases.append(self.share(alias[key], owner))
                    else:
                        [lease] = self.lease_blocks(cls, owner, 1)
                        m.leases.append(lease)
                        alias[key] = lease
                restored[(cls, owner)] = m
            # scatter the device payloads onto the fresh ids, in the
            # saved gather order
            for cls, dev in device_meta.items():
                dst = []
                for old in dev["blocks"]:
                    lease = alias.get((cls, int(old)))
                    if lease is None:
                        raise RuntimeError(
                            f"device payload of {cls!r} names block "
                            f"{old} that no snapshotted mapping holds")
                    dst.append(lease.block)
                streams = tuple(stream(cls, s) for s in dev["streams"])
                owner = f"__snapshot__/{cls}"
                nbytes = int(sum(_nbytes(t) for t in streams
                                 if t is not None))
                self.host_deposit(cls, owner, streams, nbytes)
                self.transfers.enqueue_swap_in(cls, owner, dst,
                                               kind="migrate-in")
                self.transfers.drain()
            for p in meta["payloads"]:
                cls, owner = p["cls"], self._untag_owner(p["owner"])
                streams = tuple(stream(cls, s) for s in p["streams"])
                self.host_deposit(cls, owner, streams, p["nbytes"])
        return restored


def _dtype_name(dtype: torch.dtype) -> str:
    """The reference package's name of a dtype (``"bfloat16"``, not
    ``"torch.bfloat16"``): the snapshot schema both packages read."""
    return str(dtype).rpartition(".")[2]


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"snapshot names an unknown dtype {name!r}")
    return dtype


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
