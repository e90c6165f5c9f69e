"""Architecture registry: cache disciplines over one Arena.

Counterpart of ``repro.serve.arch``.  Each model family maps to a
``CacheStrategy`` that decides what its decode-time state IS and which
Arena pool classes back it; the ``Engine`` holds exactly one strategy
and never inspects the model -- ``resolve(model)`` is the only dispatch
point.

This package serves the paged discipline so far:

* ``PagedKVStrategy`` -- transformers: the per-token growing KV cache
  behind block tables, with COW prefix sharing, suffix-only prefill,
  swap, speculative prefetch and compaction, and the resident decode
  tail (device-persistent tables, delta sync, one fused decode step).

The constant-state (SSM/RWKV) and composite (hybrid) rows are listed in
the registry and refused as not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.device import resolve_device
from repro_torch.mem import Arena, NULL_BLOCK
from repro_torch.serve.swap import HostBlockStore

__all__ = [
    "SupportedArchitecture", "ARCHITECTURES", "resolve", "build_strategy",
    "CacheStrategy", "PagedKVStrategy",
]


class CacheStrategy:
    """What a model family's decode-time state is, and how it is served.

    One instance per Engine; owns the Arena pool classes, device
    streams, managers and swap ledgers for its discipline, and is the
    scheduler's admission view (``footprint``/``free_by_class``/
    ``growing_classes``/``quota_headroom`` select the per-pool-class
    vector path in ``Scheduler.plan_admissions``).
    """

    #: full Arena pool-class names this strategy allocates in
    pool_classes: List[str]
    #: subset of pool_classes whose footprint can grow after admission
    #: (the watermark applies only to these)
    growing_classes: frozenset
    supports_suffix_prefill = False
    #: engine-set: device tables/rows are resident and delta-maintained
    resident = False

    # -- admission view (scheduler vector path) --
    def footprint(self, req) -> Dict[str, int]:
        """Worst-case per-pool-class block demand of admitting ``req``."""
        raise NotImplementedError

    def free_by_class(self) -> Dict[str, int]:
        """Grantable leases per class, crediting uncommitted prefetches
        as free (they cancel instantly under pressure, keeping the
        speculative schedule decision-identical)."""
        raise NotImplementedError

    def quota_headroom(self, tenant: str) -> Dict[str, int]:
        """Remaining per-class block budget for ``tenant`` -- only
        classes with a registered quota appear; absent = unlimited."""
        room = {}
        for cls in self.pool_classes:
            q = self.arena.tenant_quota(cls, tenant)
            if q is not None:
                used = self.arena.blocks_by_tenant(cls).get(tenant, 0)
                room[cls] = q - used
        return room

    # -- lifecycle --
    def admit(self, rid: int, prompt_tokens: int, tenant: str) -> None:
        raise NotImplementedError

    def fork(self, parent: int, child: int, shared_tokens: int,
             tenant: str) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not share prefixes")

    def extend(self, rid: int, total_tokens: int) -> List[int]:
        """Grow to cover ``total_tokens``; [] for constant disciplines."""
        raise NotImplementedError

    def ensure_writable(self, rid: int, token_pos: int):
        """COW write barrier; None when nothing was shared."""
        raise NotImplementedError

    def release(self, rid: int) -> None:
        raise NotImplementedError

    def has_seq(self, rid: int) -> bool:
        raise NotImplementedError

    # -- swap / speculation --
    def swap_out(self, rid: int) -> None:
        raise NotImplementedError

    def swap_in(self, rid: int) -> None:
        raise NotImplementedError

    def is_prefetched(self, rid: int) -> bool:
        return False

    def commit_prefetch(self, rid: int) -> Tuple[List[int], bool]:
        raise NotImplementedError

    def cancel_prefetch(self, rid: int) -> None:
        raise NotImplementedError

    def prefetched_ids(self) -> List[int]:
        return []

    def prefetch_viable(self, rid: int, watermark: int) -> bool:
        """May ``rid``'s swap-in be speculated right now? (headroom,
        residency and in-transit guards -- see Engine._maybe_prefetch)"""
        return False

    def prefetch(self, rid: int) -> None:
        raise NotImplementedError

    # -- per-step mechanism --
    def sync_device_state(self, running: Dict[int, object]) -> None:
        """Derive device tables/row indices from host truth (the read
        barrier: every running mapping must be settled)."""
        raise NotImplementedError

    def decode(self, params, tokens):
        """One decode step over the synced device state; returns logits."""
        raise NotImplementedError

    # -- resident delta-sync protocol --
    def _init_resident(self) -> None:
        """Per-instance dirty-tracking state for the delta-sync path
        (strategies call this from __init__; no super().__init__)."""
        self._dirty: set = set()        # slots whose mapping changed
        self._resident: set = set()     # slots synced as live last step
        self._all_dirty = True          # first sync scatters every slot

    def mark_dirty(self, slot: int) -> None:
        """Mapping-mutation hook: ``slot``'s device rows must re-scatter
        at the next sync (growth, COW fulfilment, fork, resume and
        swap-in all route here via the engine)."""
        self._dirty.add(slot)

    def mark_all_dirty(self) -> None:
        """Every slot's device rows are stale -- physical ids moved under
        the tables (``compact()`` lease rewrite), including the sink the
        empty slots point at."""
        self._all_dirty = True

    def _take_dirty(self, running) -> set:
        """Slots to scatter this sync: dirty live slots plus departures
        (slots that WERE live and must be reset to the sink, or their
        stale tables would clobber reallocated blocks)."""
        run = set(running)
        if self._all_dirty:
            upd = set(range(self.slots))
            self._all_dirty = False
        else:
            upd = (self._dirty & run) | (self._resident - run)
        self._dirty.clear()
        self._resident = run
        return upd

    @staticmethod
    def _bucket(n: int, slots: int) -> int:
        """Power-of-two width for the update arrays, so repeats hit a
        warm jit trace (pad entries index ``slots`` -> scatter-dropped)."""
        return min(1 << (n - 1).bit_length(), slots) if n else 0

    def full_sync_cost(self) -> Tuple[int, int]:
        """(rows, bytes) one full-rebuild sync uploads -- the eager
        fallback's per-step cost, reported beside the delta path's."""
        raise NotImplementedError

    def sync_device_state_delta(self, running) -> Tuple[int, int]:
        """Delta read barrier: scatter only the dirty slots' rows and
        stash the update arrays for ``decode_resident``; returns
        (rows_updated, bytes_staged)."""
        raise NotImplementedError

    def decode_resident(self, params, tokens):
        """Fused step tail: delta-scatter + state step + argmax in one
        jitted, buffer-donated callable; returns the DEVICE (B,)
        next-token array (the only thing that crosses to host)."""
        raise NotImplementedError

    def prefill(self, params, batch) -> Tuple[np.ndarray, int]:
        """ONE padded prefill for ``[(slot, req, shared), ...]``;
        returns (next-token per row, prompt tokens billed)."""
        raise NotImplementedError

    def prefill_suffix(self, params, batch) -> Tuple[np.ndarray, int, int]:
        raise NotImplementedError(
            f"{type(self).__name__} does not suffix-prefill")

    # -- compaction --
    def should_compact(self, *, min_free_frac: float,
                       frag_threshold: float) -> bool:
        return any(self.arena.should_compact(c, min_free_frac=min_free_frac,
                                             frag_threshold=frag_threshold)
                   for c in self.pool_classes)

    def compact_now(self) -> int:
        moved = 0
        for c in self.pool_classes:
            src, _ = self.arena.compact(c)
            moved += len(src)
        if moved:
            # leases were rewritten under the tables: every resident
            # row (including the empty slots' sink pointer) is stale
            self.mark_all_dirty()
        return moved

    # -- audit --
    def check_consistency(self, running: Dict[int, object]) -> None:
        raise NotImplementedError


class PagedKVStrategy(CacheStrategy):
    """Growing per-token KV behind block tables (transformers).

    The pre-registry engine mechanism, extracted: COW prefix sharing,
    suffix-only prefill, padded batched prefill through a pinned sink
    block, per-step table sync, swap and speculative prefetch.
    """

    def __init__(self, model, *, arena: Arena, slots: int, max_seq: int,
                 num_blocks: int, device="cuda"):
        self.model = model
        self.arena = arena
        self.slots = slots
        self.device = resolve_device(device)
        kvcfg = model.kv_config(max_seq=max_seq, num_blocks=num_blocks,
                                batch=slots)
        self.cache = PagedKVCache.create(kvcfg, slots, device=self.device)
        self.mgr = PagedKVManager(kvcfg, arena=arena)
        self._sink = self.mgr.reserve_sink()
        # resident tables START all-sink / length-0: the created cache
        # fills tables with NULL (-1), so an untouched empty slot's
        # padded decode write would otherwise land in clamped block 0.
        self.cache.block_tables.fill_(self.sink)
        self.cache.seq_lens.zero_()
        self.store = HostBlockStore(arena, self.mgr.pool_class)
        self.pool_classes = [self.mgr.pool_class]
        self.growing_classes = frozenset(self.pool_classes)
        self.supports_suffix_prefill = getattr(
            model, "supports_suffix_prefill", False)
        self._init_resident()
        self._upd = None
        arena.transfers.register_executor(
            self.mgr.pool_class, self._streams, self._set_streams)

    # -- transfer-plane executor --
    def _streams(self):
        c = self.cache
        return [c.k_pool] + ([c.v_pool] if c.v_pool is not None else [])

    def _set_streams(self, streams) -> None:
        # (k, v) pools, or the one latent pool of MLA; the block kernels
        # update them in place
        k, *rest = streams
        self.cache = dataclasses.replace(
            self.cache, k_pool=k, v_pool=rest[0] if rest else None)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array to the pools' device."""
        return torch.as_tensor(arr, device=self.device)

    @property
    def sink(self) -> int:
        return self._sink.block

    @property
    def block_tokens(self) -> int:
        return self.cache.config.block_tokens

    @property
    def utilization(self) -> float:
        return self.mgr.utilization

    @property
    def swapped(self) -> dict:
        return self.mgr.swapped

    # -- admission view --
    def footprint(self, req) -> Dict[str, int]:
        return {self.mgr.pool_class: self.mgr.blocks_needed(req.max_tokens)}

    def free_by_class(self) -> Dict[str, int]:
        return {self.mgr.pool_class: (self.mgr.free_blocks
                                      + self.mgr.speculative_blocks)}

    # -- lifecycle --
    def admit(self, rid, prompt_tokens, tenant):
        self.mgr.admit(rid, prompt_tokens, tenant=tenant)

    def fork(self, parent, child, shared_tokens, tenant):
        self.mgr.fork(parent, child, shared_tokens, tenant=tenant)

    def extend(self, rid, total_tokens):
        return self.mgr.extend(rid, total_tokens)

    def ensure_writable(self, rid, token_pos):
        return self.mgr.ensure_writable(rid, token_pos)

    def release(self, rid):
        self.mgr.release(rid)

    def has_seq(self, rid):
        return self.mgr.has_seq(rid)

    # -- swap / speculation --
    def swap_out(self, rid):
        self.mgr.swap_out(rid)

    def swap_in(self, rid):
        self.mgr.swap_in(rid)

    def is_prefetched(self, rid):
        return self.mgr.is_prefetched(rid)

    def commit_prefetch(self, rid):
        return self.mgr.commit_prefetch(rid)

    def cancel_prefetch(self, rid):
        self.mgr.cancel_prefetch(rid)

    def prefetched_ids(self):
        return self.mgr.prefetched_ids()

    def prefetch_viable(self, rid, watermark):
        if self.mgr.is_prefetched(rid) or rid not in self.mgr.swapped:
            return False
        if self.store.in_transit(rid):
            return False               # wait for the d2h fence first
        need = self.mgr.swapped[rid]
        if need == 0:
            return False
        return self.mgr.free_blocks - need >= watermark

    def prefetch(self, rid):
        self.mgr.prefetch(rid)

    # -- per-step mechanism --
    def sync_device_state(self, running) -> None:
        """Empty slots map to the SINK block, not NULL: a NULL (-1)
        entry would aim every padded decode write at block 0."""
        cfg = self.cache.config
        bt = cfg.block_tokens
        tables = np.full((self.slots, cfg.max_blocks_per_seq), self.sink,
                         np.int32)
        lens = np.zeros(self.slots, np.int32)
        writes = []
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
            tbl = self.mgr.device_table(req.rid)
            tables[slot] = tbl
            lens[slot] = req.tokens_held
            # the coming decode appends this slot's KV at token position
            # tokens_held -- dirty its tail block for live migration
            writes.append(int(tbl[req.tokens_held // bt]))
        self.mgr.allocator.note_write(writes)
        self.cache = dataclasses.replace(
            self.cache, block_tables=self._dev(tables),
            seq_lens=self._dev(lens))

    def decode(self, params, tokens):
        logits, self.cache = self.model.decode_step(params, tokens,
                                                    self.cache)
        return logits

    def full_sync_cost(self):
        mb = self.cache.config.max_blocks_per_seq
        return self.slots, self.slots * (mb + 1) * 4

    def sync_device_state_delta(self, running):
        """Delta read barrier: the device table is the cached translation
        structure; only slots whose mapping changed since the last step
        re-scatter.  Live-migration write tracking stays per-step (the
        coming decode appends at ``tokens_held`` regardless of table
        churn), read off the host mapping without building any table."""
        bt = self.cache.config.block_tokens
        writes = []
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
            writes.append(int(self.mgr.block_ids(req.rid)
                              [req.tokens_held // bt]))
        self.mgr.allocator.note_write(writes)
        upd = self._take_dirty(running)
        mb = self.cache.config.max_blocks_per_seq
        W = self._bucket(len(upd), self.slots)
        upd_slots = np.full(W, self.slots, np.int32)   # pad -> dropped
        upd_tables = np.full((W, mb), self.sink, np.int32)
        upd_lens = np.zeros(W, np.int32)
        for i, slot in enumerate(sorted(upd)):
            upd_slots[i] = slot
            if slot in running:
                req = running[slot]
                upd_tables[i] = self.mgr.device_table(req.rid)
                upd_lens[i] = req.tokens_held
            # departed slots reset to all-sink / length 0: their stale
            # tables would aim padded writes at reallocated blocks
        self._upd = (upd_slots, upd_tables, upd_lens)
        nbytes = (upd_slots.nbytes + upd_tables.nbytes + upd_lens.nbytes
                  if W else 0)
        return len(upd), nbytes

    def decode_resident(self, params, tokens):
        upd_slots, upd_tables, upd_lens = self._upd
        live = upd_slots < self.slots          # bucket padding is dropped
        nxt, self.cache = self.model.decode_fused(
            params, tokens, self.cache, self._dev(upd_slots[live]),
            self._dev(upd_tables[live]), self._dev(upd_lens[live]))
        return nxt

    def prefill(self, params, batch):
        """Rows padded to the longest block-aligned prompt; per-row
        prefill tables redirect padding AND COW-aliased prefix blocks to
        the sink, so writes land only in privately owned blocks."""
        cfg = self.cache.config
        bt = cfg.block_tokens
        lens = [req.tokens_held for _, req, _ in batch]
        S = -(-max(lens) // bt) * bt
        toks = np.zeros((len(batch), S), np.int64)
        tables = np.full((len(batch), cfg.max_blocks_per_seq), self.sink,
                         np.int32)
        for row, (slot, req, shared) in enumerate(batch):
            toks[row, : lens[row]] = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.generated, np.int64)])
            tbl = self.mgr.device_table(req.rid)
            keep = tbl != NULL_BLOCK
            keep[: -(-shared // bt) if shared else 0] = False
            tables[row, keep] = tbl[keep]
        view = PagedKVCache(self.cache.k_pool, self.cache.v_pool,
                            self._dev(tables),
                            self._dev(np.zeros(len(batch), np.int32)), cfg)
        last, _ = self.model.prefill(
            params, self._dev(toks), view,
            self._dev(np.asarray(lens, np.int32)))
        # the pools were written in place; the argmax's host copy waits
        # for the prefill to finish
        nxt = torch.argmax(last, dim=-1).cpu().numpy()
        return nxt, sum(lens)

    def prefill_suffix(self, params, batch):
        """Suffix-only prefill for forked children: each row runs the
        forward pass over just its un-cached suffix, attending through
        its FULL table (sharing saves FLOPs, not just bytes); KV writes
        route through a per-row write table (sink for aliased blocks and
        padding).  Padded width buckets to a power-of-two block count so
        repeats hit a warm jit trace."""
        cfg = self.cache.config
        bt = cfg.block_tokens
        lens = [req.tokens_held for _, req, _ in batch]
        starts = [shared if shared < lens[row]
                  else ((lens[row] - 1) // bt) * bt
                  for row, (_, _, shared) in enumerate(batch)]
        nblk = max(-(-(lens[r] - starts[r]) // bt) for r in range(len(batch)))
        nblk = min(1 << (nblk - 1).bit_length(), cfg.max_blocks_per_seq)
        S = nblk * bt
        toks = np.zeros((len(batch), S), np.int64)
        tables = np.full((len(batch), cfg.max_blocks_per_seq), self.sink,
                         np.int32)
        wtables = np.full((len(batch), nblk), self.sink, np.int32)
        for row, (slot, req, shared) in enumerate(batch):
            full = np.concatenate([np.asarray(req.prompt, np.int64),
                                   np.asarray(req.generated, np.int64)])
            toks[row, : lens[row] - starts[row]] = full[starts[row]:]
            tbl = self.mgr.device_table(req.rid)
            keep = tbl != NULL_BLOCK
            tables[row, keep] = tbl[keep]
            n_alias = -(-shared // bt)
            for j in range(nblk):
                a = starts[row] // bt + j
                if (a >= n_alias and a < len(tbl) and tbl[a] != NULL_BLOCK
                        and a * bt < lens[row]):
                    wtables[row, j] = tbl[a]
        view = PagedKVCache(self.cache.k_pool, self.cache.v_pool,
                            self._dev(tables),
                            self._dev(np.zeros(len(batch), np.int32)), cfg)
        suffix_tokens = sum(lens[r] - starts[r] for r in range(len(batch)))
        last, _ = self.model.prefill_suffix(
            params, self._dev(toks), view,
            self._dev(np.asarray(lens, np.int32)),
            self._dev(np.asarray(starts, np.int32)), self._dev(wtables))
        nxt = torch.argmax(last, dim=-1).cpu().numpy()
        return nxt, suffix_tokens, sum(starts)

    # -- audit --
    def check_consistency(self, running) -> None:
        alloc = self.mgr.allocator
        assert (alloc.num_used + alloc.num_free + alloc.num_held
                == alloc.num_blocks)
        assert alloc.refcount(self.sink) == 1
        bt = self.block_tokens
        lens = self.cache.seq_lens.cpu().numpy()
        for slot, req in running.items():
            tbl = self.mgr.block_ids(req.rid)
            assert len(tbl) * bt >= req.tokens_held
            assert all(alloc.is_allocated(b) for b in tbl)
            assert lens[slot] == req.tokens_held, (slot, lens[slot],
                                                   req.tokens_held)
        if self.resident and not self._all_dirty:
            # resident shadow vs host truth: a missed mark_dirty hook
            # surfaces HERE, not as a silent wrong-block read
            dev = self.cache.block_tables.cpu().numpy()
            for slot, req in running.items():
                if slot in self._dirty:
                    continue            # scatter staged for next sync
                want = self.mgr.device_table(req.rid)
                assert np.array_equal(dev[slot], want), (
                    f"slot {slot}: resident table diverged from mapping "
                    f"truth (missed dirty mark?)")
        transfers = self.arena.transfers
        transit = set(transfers.in_transit(self.mgr.pool_class))
        assert len(self.store) + len(transit) == len(self.mgr.swapped)
        for rid in self.mgr.swapped:
            assert rid in self.store or rid in transit
        pending_dst = transfers.in_flight_blocks(self.mgr.pool_class)
        for rid in self.mgr.tables:
            for lease in self.mgr.mapping(rid).leases:
                if lease.in_flight:
                    assert lease.block in pending_dst, (
                        f"rid {rid}: lease {lease!r} flagged in-flight "
                        f"but no pending plan targets it")
        for rid in self.mgr.prefetched_ids():
            m = self.mgr.mapping(rid)
            assert rid in self.store, (
                f"rid {rid}: prefetched but its host payload is gone")
            for lease in m._spec:
                if lease.in_flight:
                    assert lease.block in pending_dst, (
                        f"rid {rid}: speculative lease {lease!r} flagged "
                        f"in-flight but no pending plan targets it")
        self.arena.check_registry(self.mgr.pool_class)


@dataclasses.dataclass(frozen=True)
class SupportedArchitecture:
    """One registry row: model family -> cache discipline -> pools."""
    key: str                 # family or ssm kind this row matches
    strategy: Optional[type]  # CacheStrategy subclass; None = not ported
    pool_suffixes: Tuple[str, ...]   # Arena pool-class names
    description: str
    served: bool = True      # False: recognized but not engine-servable


ARCHITECTURES: Tuple[SupportedArchitecture, ...] = (
    SupportedArchitecture(
        "dense", PagedKVStrategy, ("kv",),
        "decoder transformers (dense/MoE/MLA; MoE resolves here through "
        "kv_config): growing paged KV, COW prefix sharing, suffix "
        "prefill"),
    SupportedArchitecture(
        "mamba2", None, ("state",),
        "pure SSM (mamba2): one constant state block per sequence",
        served=False),
    SupportedArchitecture(
        "hybrid", None, ("kv", "state"),
        "zamba2 hybrid: paged KV + constant state", served=False),
    SupportedArchitecture(
        "audio", None, ("kv", "xattn"),
        "whisper: paged self-attention KV + read-only cross-attention "
        "segment", served=False),
    SupportedArchitecture(
        "rwkv6", None, ("state",),
        "RWKV6: one constant state block per sequence", served=False),
)


def resolve(model) -> SupportedArchitecture:
    """Registry lookup from the model's config."""
    cfg = model.cfg
    key = cfg.family
    if getattr(cfg, "ssm", None) is not None and key not in ("hybrid",):
        key = cfg.ssm.kind
    for row in ARCHITECTURES:
        if row.key == key:
            return row
    if hasattr(model, "kv_config"):
        return ARCHITECTURES[0]
    raise NotImplementedError(
        f"no cache strategy registered for model family {cfg.family!r}")


def build_strategy(model, *, arena: Arena, slots: int, max_seq: int,
                   num_blocks: int, device="cuda") -> CacheStrategy:
    """Resolve and construct the model's strategy over ``arena``."""
    row = resolve(model)
    if not row.served or row.strategy is None:
        raise NotImplementedError(
            f"architecture {row.key!r} is not yet ported to repro_torch: "
            f"{row.description}")
    return row.strategy(model, arena=arena, slots=slots, max_seq=max_seq,
                        num_blocks=num_blocks, device=device)
