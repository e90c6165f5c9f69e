"""Architecture registry: cache disciplines over one Arena.

Counterpart of ``repro.serve.arch``.  Each model family maps to a
``CacheStrategy`` that decides what its decode-time state IS and which
Arena pool classes back it; the ``Engine`` holds exactly one strategy
and never inspects the model -- ``resolve(model)`` is the only dispatch
point.  Three disciplines:

* ``PagedKVStrategy`` -- transformers: the per-token growing KV cache
  behind block tables, with COW prefix sharing, suffix-only prefill,
  swap, speculative prefetch and compaction, and the resident decode
  tail (device-persistent tables, delta sync, one fused decode step,
  replayed from a captured CUDA graph per update width:
  ``serve/decode_graph.py``), and the prefill and suffix prefill replayed
  from a captured CUDA graph per ``(B, S)`` bucket from its second
  sighting on (``serve/prefill_graph.py``), the two kinds in one graph
  pool.
* ``ConstantStateStrategy`` -- SSMs (mamba2, rwkv6): ONE fixed-size
  float32 state block per sequence in a flat pool, allocated at
  admission and never grown.  Zero watermark pressure (the footprint is
  exact), one block moves the whole sequence on swap, no prefix sharing
  (the recurrent state depends on the entire prefix).
* ``CompositeStrategy`` -- the zamba2 hybrid: a growing paged-KV class
  for the shared-attention streams AND a constant-state class for the
  Mamba2 backbone, admitted, swapped and released together; no prefix
  sharing, no suffix prefill, no speculative prefetch.

The whisper row (paged self-attention KV + a ``ReadOnlySegment`` for
the cross-attention K/V) is listed with the reference's
``CompositeStrategy`` and ``served=False``: ``build_strategy`` refuses
it, as the reference's does.  It also refuses an image-prefixed VLM
(``cfg.num_image_tokens``): the engine hands a model its prompt tokens
and no image embeddings.  ``pool_prefix`` namespaces a strategy's pool
classes, so engines of different families can share one Arena.

A flat state pool moves through the transfer plane like a paged one:
compaction copies rows with the ``block_copy`` kernel (#6), swap-out
gathers ``pool[ids]`` and swap-in writes ``pool[ids] = payload``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.device import resolve_device
from repro_torch.mem import Arena, Mapping, NULL_BLOCK, OutOfBlocksError
from repro_torch.serve.decode_graph import DecodeGraphs
from repro_torch.serve.graphs import GraphPool
from repro_torch.serve.prefill_graph import PrefillGraphs
from repro_torch.serve.swap import HostBlockStore

__all__ = [
    "SupportedArchitecture", "ARCHITECTURES", "resolve", "build_strategy",
    "CacheStrategy", "PagedKVStrategy", "ConstantStateStrategy",
    "CompositeStrategy", "ConstantStateManager", "ReadOnlySegment",
]


# ---------------------------------------------------------------------------
# read-only segment (whisper's cross-attention K/V)
# ---------------------------------------------------------------------------
class ReadOnlySegment:
    """A block segment deposited once and shared by refcount to every
    reader.

    Whisper's cross-attention K/V is computed ONCE from the encoder
    output and then only read by the decode beams: a growing discipline
    is wrong (it never grows) and a private copy per beam is waste.
    ``deposit`` allocates the segment's blocks (written once, at
    encode); ``share`` hands a reader an alias of the whole segment
    (refcounts only, no bytes); and there is deliberately no write
    barrier -- ``ensure_writable`` on a read-only segment is a bug, not
    a copy on write: the paper's read-only sharing with no hardware
    protection bit.  The segment relocates like any other mapping
    (``migrate``)."""

    def __init__(self, arena: Arena, pool_class: str):
        self.arena = arena
        self.pool_class = pool_class
        self._segments: Dict[object, Mapping] = {}
        self._readers: Dict[object, Mapping] = {}

    def deposit(self, owner, nblocks: int) -> List[int]:
        """Allocate the segment's ``nblocks`` blocks for ``owner``."""
        if owner in self._segments:
            raise ValueError(f"segment {owner!r} already deposited")
        m = self.arena.mapping(self.pool_class, owner)
        self._segments[owner] = m
        return m.ensure_capacity(nblocks)

    def share(self, owner, reader) -> List[int]:
        """Alias ``owner``'s whole segment to ``reader``: refcounts only."""
        seg = self._segments[owner]
        child = seg.fork(reader, len(seg))
        self._readers[reader] = child
        return child.block_ids()

    def block_ids(self, owner) -> List[int]:
        """The block ids of a segment or of a reader's alias."""
        m = (self._segments[owner] if owner in self._segments
             else self._readers[owner])
        return m.block_ids()

    def ensure_writable(self, owner, idx: int):
        raise TypeError(
            f"segment {owner!r} is read-only: cross-attention K/V is "
            f"deposited once at encode time; a write barrier here means a "
            f"decode path is trying to mutate shared encoder output")

    def drop_reader(self, reader) -> None:
        self._readers.pop(reader).free()

    def release(self, owner) -> None:
        """Free the segment itself (readers keep their aliases alive)."""
        self._segments.pop(owner).free()

    def migrate(self, owner, to: str) -> List[int]:
        """Move the segment to ``to`` (``"host"`` or ``"device"``)."""
        return self._segments[owner].migrate(to)


# ---------------------------------------------------------------------------
# constant-state pool manager
# ---------------------------------------------------------------------------
class ConstantStateManager:
    """Fixed-size per-sequence state blocks over one Arena pool class.

    The SSM analogue of ``PagedKVManager``: every sequence owns exactly
    ONE block of ``state_elems`` float32 elements (the flattened
    recurrent state), allocated at admission and never grown.  The
    device stream is a flat ``(num_blocks, state_elems)`` pool registered
    with the transfer plane (``layered=False``), so swap-out, swap-in,
    prefetch and compaction ride the same plans as paged KV.
    """

    def __init__(self, arena: Arena, pool_class: str, state_elems: int,
                 num_blocks: int, device):
        if state_elems <= 0:
            raise ValueError("state_elems must be positive")
        self.arena = arena
        self.state_elems = state_elems
        self.pool_class = arena.register_class(
            pool_class, num_blocks=num_blocks,
            block_shape=(state_elems,), dtype=torch.float32)
        self.pool = torch.zeros((num_blocks, state_elems),
                                dtype=torch.float32, device=device)
        self._maps: Dict[int, Mapping] = {}
        arena.transfers.register_executor(
            self.pool_class, self._streams, self._set_streams,
            layered=False)

    # -- transfer-plane executor (flat single stream) --
    def _streams(self):
        return [self.pool]

    def _set_streams(self, streams) -> None:
        self.pool = streams[0]

    # -- views --
    @property
    def allocator(self):
        return self.arena.allocator(self.pool_class)

    @property
    def free_blocks(self) -> int:
        return self.arena.num_free(self.pool_class)

    @property
    def swapped(self) -> dict:
        return self.arena.host_counts(self.pool_class)

    @property
    def utilization(self) -> float:
        return (self.arena.num_used(self.pool_class)
                / self.arena.num_blocks(self.pool_class))

    def mapping(self, seq_id: int) -> Mapping:
        return self._maps[seq_id]

    def has_seq(self, seq_id: int) -> bool:
        m = self._maps.get(seq_id)
        return m is not None and m.placement == "device"

    def row(self, seq_id: int) -> int:
        """Physical pool row of the sequence's (single) state block."""
        return self._maps[seq_id].block_ids()[0]

    # -- lifecycle --
    def admit(self, seq_id: int, tenant: str = "default") -> List[int]:
        if self.free_blocks < 1:
            raise OutOfBlocksError(
                f"constant-state pool {self.pool_class!r} exhausted")
        m = self.arena.mapping(self.pool_class, seq_id, tenant=tenant)
        self._maps[seq_id] = m
        return m.ensure_capacity(1)

    def release(self, seq_id: int) -> None:
        self._maps.pop(seq_id).free()

    def adopt(self, seq_id: int, mapping: Mapping) -> None:
        if mapping.pool_class != self.pool_class:
            raise ValueError(
                f"adopt of mapping in pool class {mapping.pool_class!r}; "
                f"this manager allocates in {self.pool_class!r}")
        if seq_id in self._maps:
            raise ValueError(f"sequence {seq_id} already tracked")
        self._maps[seq_id] = mapping

    def disown(self, seq_id: int) -> Mapping:
        """Inverse of ``adopt``: stop tracking without freeing (the
        disaggregation handoff's export side)."""
        return self._maps.pop(seq_id)

    def reserve_sink(self):
        """Pin one row as the scatter target for empty decode slots."""
        return self.arena.pin(self.pool_class, owner="sink")

    # -- swapping / speculation (generic Mapping verbs) --
    def swap_out(self, seq_id: int) -> List[int]:
        return self._maps[seq_id].migrate("host")

    def swap_in(self, seq_id: int) -> List[int]:
        return self._maps[seq_id].migrate("device")

    def prefetch(self, seq_id: int) -> List[int]:
        return self._maps[seq_id].prefetch()

    def is_prefetched(self, seq_id: int) -> bool:
        m = self._maps.get(seq_id)
        return m is not None and m.prefetched

    def prefetched_ids(self) -> List[int]:
        return [sid for sid, m in self._maps.items() if m.prefetched]

    def commit_prefetch(self, seq_id: int) -> Tuple[List[int], bool]:
        return self._maps[seq_id].commit_prefetch()

    def cancel_prefetch(self, seq_id: int) -> None:
        self._maps[seq_id].cancel_prefetch()

    @property
    def speculative_blocks(self) -> int:
        return sum(m.spec_blocks for m in self._maps.values())


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
    supports_prefix_sharing = False
    supports_suffix_prefill = False
    #: engine-set: device tables/rows are resident and delta-maintained
    resident = False
    #: engine-set: the resident tail and the paged prefill buckets (from
    #: a bucket's second sighting on) replay captured CUDA graphs (on a
    #: CUDA device; the CPU runs the same static-buffer bodies eagerly)
    graphs = True
    #: where the strategy's pools live
    device: torch.device

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pools' device without blocking the host:
        on a CUDA device through a pinned buffer of PyTorch's caching
        host allocator, which keeps the buffer until the copy has run."""
        t = torch.from_numpy(np.array(arr))    # a copy: arr may change
        if self.device.type != "cuda":
            return t
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(self.device, non_blocking=True)

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
        self._live: set = set()         # slots synced as live last step
        self._all_dirty = True          # first sync scatters every slot
        self._upd = None
        self._graphs: Optional[DecodeGraphs] = None
        self._prefill_graphs: Optional[PrefillGraphs] = None
        #: the graph pool and side stream that both kinds share
        self._graph_pool: Optional[GraphPool] = None

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
            upd = (self._dirty & run) | (self._live - run)
        self._dirty.clear()
        self._live = run
        return upd

    @staticmethod
    def _bucket(n: int, slots: int) -> int:
        """Power-of-two width for the update arrays, so repeats replay
        one captured graph (pad entries index ``slots``, the resident
        tensors' scratch row: dropped on the device)."""
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
        """Fused step tail: the update arrays' splice into the resident
        tensors (in place; pad entries land in their scratch row, so
        they are dropped on the device), one decode step and the argmax,
        replayed from one captured CUDA graph per update width W
        (``serve/decode_graph.py``; eager on the same static buffers on
        the CPU or with ``graphs=False``).  Returns a fresh DEVICE
        (B,) next-token array, the only thing that crosses to host."""
        if self._graphs is None:
            self._graphs = DecodeGraphs(self.slots, self.device,
                                        graphs=self.graphs,
                                        pool=self._shared_graph_pool())
        return self._graphs.run(self, params, tokens, self._upd)

    def _shared_graph_pool(self) -> GraphPool:
        if self._graph_pool is None:
            self._graph_pool = GraphPool(self.device)
        return self._graph_pool

    def release_graphs(self) -> None:
        """Drop the captured decode and prefill graphs (each bucket is
        captured again when it is next met); their pool returns to the
        card with ``torch.cuda.empty_cache()``."""
        for g in (self._graphs, self._prefill_graphs):
            if g is not None:
                g.release()

    @property
    def graph_stats(self) -> Dict[str, object]:
        """The decode graphs' captures per bucket, recaptures, replays,
        pool bytes and capture seconds (none before the first resident
        step), and under ``"prefill"`` the prefill buckets' stats
        (``PrefillGraphs.stats``; empty before the first paged
        prefill)."""
        out = {} if self._graphs is None else dict(self._graphs.stats)
        out["prefill"] = ({} if self._prefill_graphs is None
                          else self._prefill_graphs.stats)
        return out

    # -- the resident tail's parts (see serve/decode_graph.py) --
    #: the resident tensors the splice writes, each with ``slots + 1``
    #: rows: the last is the scratch row that pad entries land in
    _resident: Tuple[torch.Tensor, ...] = ()

    def _pad_update(self, W: int) -> Tuple[np.ndarray, ...]:
        """Host update arrays of width ``W``, all pads: the slot vector
        (``slots``), then one array per resident tensor, holding its
        empty-slot value."""
        raise NotImplementedError

    def _pools(self) -> List[torch.Tensor]:
        """The pools the resident tail reads and writes."""
        raise NotImplementedError

    def _tail(self, params, tokens, resident, upd) -> torch.Tensor:
        """Splice ``upd`` into ``resident``, decode one step over their
        first ``slots`` rows and return the (B,) argmax; no host sync and
        no data-dependent shape, so a CUDA graph can capture it."""
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

    # -- restart / migration / teardown --
    def managers(self) -> list:
        """The block managers, in ``pool_classes`` order."""
        return [self.mgr]

    #: the reference's messages when a restored mapping is missing or
    #: placed wrong, by the placement the adopt expects
    _adopt_errors = {
        "host": ("no restored host-resident mapping for rid {rid}; run "
                 "Arena.restore first (device-resident sequences do not "
                 "survive a restart -- re-submit them)"),
        "device": ("no device-resident mapping for rid {rid}; restore a "
                   "device snapshot (live migration) or adopt_payload a "
                   "handoff bundle first"),
    }

    def _adopt(self, rid, placement: str) -> None:
        """Adopt ``rid``'s restored mapping in every pool class, after
        checking that each exists with ``placement``."""
        found = []
        for mgr in self.managers():
            m = self.arena.find_mapping(mgr.pool_class, rid)
            if m is None or m.placement != placement:
                raise ValueError(self._adopt_errors[placement].format(
                    cls=mgr.pool_class, rid=rid))
            found.append(m)
        for mgr, m in zip(self.managers(), found):
            mgr.adopt(rid, m)

    def adopt_restored(self, rid) -> None:
        """Adopt a host-resident mapping rebuilt by ``Arena.restore``
        (the restart path); the engine queues the request for resume."""
        self._adopt(rid, "host")

    def adopt_device(self, rid) -> None:
        """Adopt a device-resident mapping restored from a live-migration
        snapshot or scattered by ``adopt_payload``; the engine places the
        request in a slot, which marks that slot's resident rows dirty."""
        self._adopt(rid, "device")

    def release_arena(self) -> None:
        """Unbind this strategy from its arena: executors, swap ledgers,
        and the captured decode and prefill graphs, which hold the
        addresses of the pools and the params."""
        for cls in self.pool_classes:
            self.arena.transfers.unregister_executor(cls)
            self.arena.transfers.remove_observer(f"swap-ledger:{cls}")
        self.release_graphs()

    # -- audit --
    def check_consistency(self, running: Dict[int, object]) -> None:
        raise NotImplementedError


class PagedKVStrategy(CacheStrategy):
    """Growing per-token KV behind block tables (transformers).

    The pre-registry engine mechanism, extracted: COW prefix sharing,
    suffix-only prefill, padded batched prefill through a pinned sink
    block, per-step table sync, swap and speculative prefetch.
    """

    supports_prefix_sharing = True

    def __init__(self, model, *, arena: Arena, slots: int, max_seq: int,
                 num_blocks: int, pool_prefix: str = "", device="cuda"):
        self.model = model
        self.arena = arena
        self.slots = slots
        self.device = resolve_device(device)
        kvcfg = model.kv_config(max_seq=max_seq, num_blocks=num_blocks,
                                batch=slots)
        self.mgr = PagedKVManager(kvcfg, arena=arena,
                                  pool_class=pool_prefix + "kv")
        self._sink = self.mgr.reserve_sink()
        self.cache, self._resident = _resident_cache(kvcfg, slots, self.sink,
                                                     self.device)
        self.store = HostBlockStore(arena, self.mgr.pool_class)
        self.pool_classes = [self.mgr.pool_class]
        self.growing_classes = frozenset(self.pool_classes)
        self.supports_suffix_prefill = getattr(
            model, "supports_suffix_prefill", False)
        self._init_resident()
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
        W = self._bucket(len(upd), self.slots)
        upd_slots, upd_tables, upd_lens = self._pad_update(W)
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

    def _pad_update(self, W):
        mb = self.cache.config.max_blocks_per_seq
        return (np.full(W, self.slots, np.int32),
                np.full((W, mb), self.sink, np.int32), np.zeros(W, np.int32))

    def _pools(self):
        return self._streams()

    def _tail(self, params, tokens, resident, upd):
        c = self.cache
        nxt, _ = self.model.decode_fused(
            params, tokens, PagedKVCache(c.k_pool, c.v_pool, *resident,
                                         c.config), *upd)
        return nxt

    def prefill(self, params, batch):
        """Rows padded to the longest block-aligned prompt; per-row
        prefill tables redirect padding AND COW-aliased prefix blocks to
        the sink, so writes land only in privately owned blocks.  The
        device part replays the bucket's captured graph from its second
        sighting on (``serve/prefill_graph.py``)."""
        cfg = self.cache.config
        bt = cfg.block_tokens
        lens = [req.tokens_held for _, req, _ in batch]
        S = -(-max(lens) // bt) * bt
        toks, tables, lengths = self._prefill_pad("prefill", len(batch), S)
        lengths[:] = lens
        for row, (slot, req, shared) in enumerate(batch):
            toks[row, : lens[row]] = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.generated, np.int64)])
            tbl = self.mgr.device_table(req.rid)
            keep = tbl != NULL_BLOCK
            keep[: -(-shared // bt) if shared else 0] = False
            tables[row, keep] = tbl[keep]
        nxt = self._prefill_run(params, "prefill", (toks, tables, lengths))
        return nxt, sum(lens)

    def prefill_suffix(self, params, batch):
        """Suffix-only prefill for forked children: each row runs the
        forward pass over just its un-cached suffix, attending through
        its FULL table (sharing saves FLOPs, not just bytes); KV writes
        route through a per-row write table (sink for aliased blocks and
        padding).  Padded width buckets to a power-of-two block count so
        repeats replay one captured graph (``serve/prefill_graph.py``)."""
        cfg = self.cache.config
        bt = cfg.block_tokens
        lens = [req.tokens_held for _, req, _ in batch]
        starts = [shared if shared < lens[row]
                  else ((lens[row] - 1) // bt) * bt
                  for row, (_, _, shared) in enumerate(batch)]
        nblk = max(-(-(lens[r] - starts[r]) // bt) for r in range(len(batch)))
        nblk = min(1 << (nblk - 1).bit_length(), cfg.max_blocks_per_seq)
        S = nblk * bt
        toks, tables, lengths, starts_a, wtables = self._prefill_pad(
            "suffix", len(batch), S)
        lengths[:] = lens
        starts_a[:] = starts
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
        suffix_tokens = sum(lens[r] - starts[r] for r in range(len(batch)))
        nxt = self._prefill_run(params, "suffix",
                                (toks, tables, lengths, starts_a, wtables))
        return nxt, suffix_tokens, sum(starts)

    # -- the prefill buckets' parts (see serve/prefill_graph.py) --
    def _prefill_run(self, params, kind: str, arrays):
        """``kind``'s prefill on the host arrays through the strategy's
        ``PrefillGraphs`` (``serve/prefill_graph.py``); returns the
        argmax as a host array."""
        if self._prefill_graphs is None:
            self._prefill_graphs = PrefillGraphs(
                self.device, graphs=self.graphs,
                pool=self._shared_graph_pool())
        nxt = self._prefill_graphs.run(self, params, kind, arrays)
        # the pools were written in place; the argmax's host copy waits
        # for the prefill to finish
        return nxt.cpu().numpy()

    def _prefill_pad(self, kind: str, B: int, S: int):
        """A bucket's host arrays, all pads: tokens 0, the prefill table
        all sink (never NULL: ``write_prefill`` clamps NULL to the live
        block 0), lengths S; for ``"suffix"`` also starts 0 and the write
        table all sink.  Every write through them lands in the sink."""
        cfg = self.cache.config
        out = (np.zeros((B, S), np.int64),
               np.full((B, cfg.max_blocks_per_seq), self.sink, np.int32),
               np.full(B, S, np.int32))
        if kind == "suffix":
            out += (np.zeros(B, np.int32),
                    np.full((B, S // cfg.block_tokens), self.sink, np.int32))
        return out

    def _prefill_body(self, params, kind: str, bufs):
        """The device part of a prefill over the bucket's buffers: the
        view over the pools, the model's prefill (writing the pools in
        place) and the argmax.  Returns ``(argmax (B,), last logits (B,
        V))``; no host sync and no data-dependent shape, so a CUDA graph
        can capture it."""
        c = self.cache
        toks, tables, lengths = bufs[:3]
        view = PagedKVCache(c.k_pool, c.v_pool, tables, lengths, c.config)
        if kind == "prefill":
            last, _ = self.model.prefill(params, toks, view, lengths)
        else:
            last, _ = self.model.prefill_suffix(params, toks, view, lengths,
                                                *bufs[3:])
        return torch.argmax(last, dim=-1), last

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


class ConstantStateStrategy(CacheStrategy):
    """Fixed-size recurrent state, one block per sequence (SSM models).

    The pool IS the authoritative device state: every decode gathers
    each running slot's state row, steps the model, and scatters the
    new rows back -- so a swap-out gather at any step boundary reads
    the current state, and a resume is one block's scatter.  Footprint
    is EXACT (1 block, never grows): admission applies no watermark to
    this class, and preemption of one sequence always frees exactly
    what the next admission of its kind needs.  The resident decode
    keeps the slots' row indices on the device and splices in only the
    rows of slots whose mapping changed.
    """

    def __init__(self, model, *, arena: Arena, slots: int, max_seq: int,
                 num_blocks: int, pool_prefix: str = "", device="cuda"):
        self.model = model
        self.arena = arena
        self.slots = slots
        self.device = resolve_device(device)
        self.mgr = ConstantStateManager(arena, pool_prefix + "state",
                                        model.state_elems, num_blocks,
                                        self.device)
        self._sink = self.mgr.reserve_sink()
        self.store = HostBlockStore(arena, self.mgr.pool_class)
        self.pool_classes = [self.mgr.pool_class]
        self.growing_classes = frozenset()      # footprint is exact
        # padded prefill must keep the SSD chunk divisibility invariant
        self._pad = max(1, getattr(model.cfg.ssm, "chunk", 1))
        self._rows = np.full(slots, self.sink, np.int64)
        self._init_resident()
        # device-resident row indices, and a scratch row for pad entries
        self._rows_dev = torch.full((slots + 1,), self.sink,
                                    dtype=torch.long, device=self.device)
        self._resident = (self._rows_dev,)

    @property
    def sink(self) -> int:
        return self._sink.block

    @property
    def block_tokens(self) -> int:
        """No paged table: prefix granularity is irrelevant (the
        recurrent state folds the whole prefix), but the engine's
        bookkeeping wants a positive quantum."""
        return 1

    @property
    def utilization(self) -> float:
        return self.mgr.utilization

    @property
    def swapped(self) -> dict:
        return self.mgr.swapped

    # -- admission view --
    def footprint(self, req) -> Dict[str, int]:
        return {self.mgr.pool_class: 1}

    def free_by_class(self) -> Dict[str, int]:
        return {self.mgr.pool_class: (self.mgr.free_blocks
                                      + self.mgr.speculative_blocks)}

    # -- lifecycle --
    def admit(self, rid, prompt_tokens, tenant):
        self.mgr.admit(rid, tenant=tenant)

    def extend(self, rid, total_tokens):
        return []                       # constant: zero growth, ever

    def ensure_writable(self, rid, token_pos):
        return None                     # nothing is ever COW-shared

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
            return False
        return self.mgr.free_blocks - 1 >= watermark

    def prefetch(self, rid):
        self.mgr.prefetch(rid)

    # -- per-step mechanism --
    def _step_rows(self, params, tokens, rows: torch.Tensor):
        """Gather the slots' state rows, step the model, scatter the new
        rows back (the pool stays authoritative, so a later swap-out
        gather always reads the current state); returns the logits."""
        pool = self.mgr.pool
        state = self.model.rows_to_state(pool[rows])
        logits, new_state = self.model.decode_step(params, tokens, state)
        pool[rows] = self.model.state_to_rows(new_state)
        return logits

    def sync_device_state(self, running) -> None:
        rows = np.full(self.slots, self.sink, np.int64)
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
            rows[slot] = self.mgr.row(req.rid)
        # every decode scatters fresh state into every running row --
        # dirty them all for live migration
        self.mgr.allocator.note_write(
            [int(r) for r in rows if r != self.sink])
        self._rows = rows

    def decode(self, params, tokens):
        return self._step_rows(params, tokens,
                               self._dev(self._rows))

    def full_sync_cost(self):
        return self.slots, self.slots * 4

    def sync_device_state_delta(self, running):
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
        # every decode scatters fresh state into every running row
        self.mgr.allocator.note_write(
            [int(self.mgr.row(req.rid)) for req in running.values()])
        upd = self._take_dirty(running)
        W = self._bucket(len(upd), self.slots)
        upd_slots, upd_rows = self._pad_update(W)
        for i, slot in enumerate(sorted(upd)):
            upd_slots[i] = slot
            if slot in running:
                upd_rows[i] = self.mgr.row(running[slot].rid)
            self._rows[slot] = upd_rows[i]             # host shadow
        self._upd = (upd_slots, upd_rows)
        return len(upd), (upd_slots.nbytes + upd_rows.nbytes if W else 0)

    def _pad_update(self, W):
        return np.full(W, self.slots, np.int32), np.full(W, self.sink,
                                                         np.int32)

    def _pools(self):
        return [self.mgr.pool]

    def _tail(self, params, tokens, resident, upd):
        """Row delta-splice -> state gather -> decode step -> state
        scatter-back -> argmax, with the row index vector latched on the
        device between steps; nothing here waits for the host."""
        _splice(resident, upd)
        logits = self._step_rows(params, tokens, resident[0][:self.slots])
        return torch.argmax(logits, dim=-1)

    def prefill(self, params, batch):
        """Padded batched prefill from zero state; ``lengths`` masks the
        right padding out of the scan exactly, so this is token-identical
        to per-sequence prefill."""
        # eager, no prefill graph: the reference jits only this
        # discipline's fused decode, never its prefill
        lens = [req.tokens_held for _, req, _ in batch]
        S = -(-max(lens) // self._pad) * self._pad
        toks = np.zeros((len(batch), S), np.int64)
        for row, (_, req, _) in enumerate(batch):
            toks[row, : lens[row]] = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.generated, np.int64)])
        state0 = self.model.init_state(len(batch), device=self.device)
        last, state = self.model.prefill(
            params, self._dev(toks), state0,
            self._dev(np.asarray(lens, np.int32)))
        idx = np.asarray([self.mgr.row(req.rid) for _, req, _ in batch],
                         np.int64)
        self.mgr.pool[self._dev(idx)] = self.model.state_to_rows(state)
        nxt = torch.argmax(last, dim=-1).cpu().numpy()   # completion
        return nxt, sum(lens)

    # -- audit --
    def check_consistency(self, running) -> None:
        alloc = self.mgr.allocator
        assert (alloc.num_used + alloc.num_free + alloc.num_held
                == alloc.num_blocks)
        assert alloc.refcount(self.sink) == 1
        for slot, req in running.items():
            m = self.mgr.mapping(req.rid)
            assert len(m) == 1 and m.placement == "device"
            assert alloc.is_allocated(m.block_ids()[0])
        if self.resident and not self._all_dirty:
            dev = self._rows_dev.cpu().numpy()
            for slot, req in running.items():
                if slot in self._dirty:
                    continue
                assert dev[slot] == self.mgr.row(req.rid), (
                    f"slot {slot}: resident state row diverged from "
                    f"mapping truth (missed dirty mark?)")
        transfers = self.arena.transfers
        transit = set(transfers.in_transit(self.mgr.pool_class))
        assert len(self.store) + len(transit) == len(self.mgr.swapped)
        for rid in self.mgr.swapped:
            assert rid in self.store or rid in transit
        self.arena.check_registry(self.mgr.pool_class)


class CompositeStrategy(CacheStrategy):
    """Hybrid: a growing paged-KV class AND a constant-state class,
    admitted, swapped, preempted and released together (zamba2).

    The watermark applies only to the KV class; the state side's
    footprint is exact.  Prefix sharing is off: the recurrent state
    depends on the entire prefix, so aliasing KV blocks alone would
    serve the wrong state.  Speculative prefetch is off for the same
    compound reason (a half-arrived sequence is unusable) -- demand
    swap-in moves both classes' plans in one dispatch.
    """

    def __init__(self, model, *, arena: Arena, slots: int, max_seq: int,
                 num_blocks: int, pool_prefix: str = "",
                 state_blocks: Optional[int] = None, device="cuda"):
        from repro_torch.models.zamba2 import ZambaState

        self._state_cls = ZambaState
        self.model = model
        self.arena = arena
        self.slots = slots
        self.device = resolve_device(device)
        kvcfg = model.kv_config(max_seq=max_seq, num_blocks=num_blocks,
                                batch=slots)
        self.mgr = PagedKVManager(kvcfg, arena=arena,
                                  pool_class=pool_prefix + "kv")
        self._kv_sink = self.mgr.reserve_sink()
        self.cache, kv_resident = _resident_cache(kvcfg, slots, self.sink,
                                                  self.device)
        # device rows: resident slots + one in-flight resume + sink
        self.state_mgr = ConstantStateManager(
            arena, pool_prefix + "state", model.state_elems,
            state_blocks if state_blocks is not None else 2 * slots + 2,
            self.device)
        self._state_sink = self.state_mgr.reserve_sink()
        self.store = HostBlockStore(arena, self.mgr.pool_class)
        self.state_store = HostBlockStore(arena, self.state_mgr.pool_class)
        self.pool_classes = [self.mgr.pool_class, self.state_mgr.pool_class]
        self.growing_classes = frozenset([self.mgr.pool_class])
        bt = kvcfg.block_tokens
        chunk = max(1, getattr(model.cfg.ssm, "chunk", 1))
        self._pad = bt * chunk // math.gcd(bt, chunk)
        self._rows = np.full(slots, self.state_sink, np.int64)
        self._init_resident()
        self._rows_dev = torch.full((slots + 1,), self.state_sink,
                                    dtype=torch.long, device=self.device)
        self._resident = kv_resident + (self._rows_dev,)
        arena.transfers.register_executor(
            self.mgr.pool_class, self._streams, self._set_streams)

    def _streams(self):
        c = self.cache
        return [c.k_pool, c.v_pool]

    def _set_streams(self, streams) -> None:
        k, v = streams
        self.cache = dataclasses.replace(self.cache, k_pool=k, v_pool=v)

    _adopt_errors = {
        "host": ("no restored host-resident {cls!r} mapping for rid {rid}; "
                 "run Arena.restore first"),
        "device": ("no device-resident {cls!r} mapping for rid {rid}; "
                   "restore a device snapshot first"),
    }

    def managers(self):
        return [self.mgr, self.state_mgr]

    @property
    def sink(self) -> int:
        return self._kv_sink.block

    @property
    def state_sink(self) -> int:
        return self._state_sink.block

    @property
    def block_tokens(self) -> int:
        return self.cache.config.block_tokens

    @property
    def utilization(self) -> float:
        return self.mgr.utilization

    @property
    def swapped(self) -> dict:
        return self.mgr.swapped       # state residency mirrors kv 1:1

    # -- admission view --
    def footprint(self, req) -> Dict[str, int]:
        return {self.mgr.pool_class: self.mgr.blocks_needed(req.max_tokens),
                self.state_mgr.pool_class: 1}

    def free_by_class(self) -> Dict[str, int]:
        return {self.mgr.pool_class: self.mgr.free_blocks,
                self.state_mgr.pool_class: self.state_mgr.free_blocks}

    # -- lifecycle (both classes, always together) --
    def admit(self, rid, prompt_tokens, tenant):
        self.mgr.admit(rid, prompt_tokens, tenant=tenant)
        try:
            self.state_mgr.admit(rid, tenant=tenant)
        except OutOfBlocksError:
            self.mgr.release(rid)     # atomic: no half-admitted hybrid
            raise

    def extend(self, rid, total_tokens):
        return self.mgr.extend(rid, total_tokens)

    def ensure_writable(self, rid, token_pos):
        return None                   # no prefix sharing -> never shared

    def release(self, rid):
        self.mgr.release(rid)
        self.state_mgr.release(rid)

    def has_seq(self, rid):
        return self.mgr.has_seq(rid)

    # -- swap (both classes ride the same dispatch) --
    def swap_out(self, rid):
        self.mgr.swap_out(rid)
        self.state_mgr.swap_out(rid)

    def swap_in(self, rid):
        self.mgr.swap_in(rid)
        self.state_mgr.swap_in(rid)

    # -- per-step mechanism --
    def _step_rows(self, params, tokens, cache: PagedKVCache,
                   rows: torch.Tensor):
        """Gather the slots' state rows, decode over them and ``cache``
        (the KV append and the seq_lens advance in place), and scatter
        the new rows back: between steps the device lens equal
        tokens_held, which ``check_consistency`` audits."""
        pool = self.state_mgr.pool
        conv, ssd = self.model.rows_to_state(pool[rows])
        logits, st = self.model.decode_step(
            params, tokens, self._state_cls(conv, ssd, cache), in_place=True)
        pool[rows] = self.model.state_to_rows(st.conv, st.ssd)
        return logits

    def sync_device_state(self, running) -> None:
        cfg = self.cache.config
        tables = np.full((self.slots, cfg.max_blocks_per_seq), self.sink,
                         np.int32)
        lens = np.zeros(self.slots, np.int32)
        rows = np.full(self.slots, self.state_sink, np.int64)
        bt = cfg.block_tokens
        kv_writes = []
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
            self.state_mgr.mapping(req.rid).assert_settled()
            tbl = self.mgr.device_table(req.rid)
            tables[slot] = tbl
            lens[slot] = req.tokens_held
            rows[slot] = self.state_mgr.row(req.rid)
            kv_writes.append(int(tbl[req.tokens_held // bt]))
        # dirty the decode write targets for live migration: the KV
        # tail block AND the state row of every running sequence
        self.mgr.allocator.note_write(kv_writes)
        self.state_mgr.allocator.note_write(
            [int(r) for r in rows if r != self.state_sink])
        self.cache = dataclasses.replace(
            self.cache, block_tables=self._dev(tables),
            seq_lens=self._dev(lens))
        self._rows = rows

    def decode(self, params, tokens):
        return self._step_rows(params, tokens, self.cache,
                               self._dev(self._rows))

    def full_sync_cost(self):
        mb = self.cache.config.max_blocks_per_seq
        return self.slots, self.slots * (mb + 2) * 4

    def sync_device_state_delta(self, running):
        """Both disciplines' deltas ride ONE update-slot vector: a slot
        is dirty for its KV table and its state row together (admission,
        swap and release move both classes atomically)."""
        bt = self.cache.config.block_tokens
        kv_writes, st_writes = [], []
        for slot, req in running.items():
            self.mgr.mapping(req.rid).assert_settled()
            self.state_mgr.mapping(req.rid).assert_settled()
            kv_writes.append(int(self.mgr.block_ids(req.rid)
                                 [req.tokens_held // bt]))
            st_writes.append(int(self.state_mgr.row(req.rid)))
        self.mgr.allocator.note_write(kv_writes)
        self.state_mgr.allocator.note_write(st_writes)
        upd = self._take_dirty(running)
        W = self._bucket(len(upd), self.slots)
        upd_slots, upd_tables, upd_lens, upd_rows = self._pad_update(W)
        for i, slot in enumerate(sorted(upd)):
            upd_slots[i] = slot
            if slot in running:
                req = running[slot]
                upd_tables[i] = self.mgr.device_table(req.rid)
                upd_lens[i] = req.tokens_held
                upd_rows[i] = self.state_mgr.row(req.rid)
            self._rows[slot] = upd_rows[i]             # host shadow
        self._upd = (upd_slots, upd_tables, upd_lens, upd_rows)
        nbytes = (upd_slots.nbytes + upd_tables.nbytes + upd_lens.nbytes
                  + upd_rows.nbytes if W else 0)
        return len(upd), nbytes

    def _pad_update(self, W):
        mb = self.cache.config.max_blocks_per_seq
        return (np.full(W, self.slots, np.int32),
                np.full((W, mb), self.sink, np.int32), np.zeros(W, np.int32),
                np.full(W, self.state_sink, np.int32))

    def _pools(self):
        return self._streams() + [self.state_mgr.pool]

    def _tail(self, params, tokens, resident, upd):
        """Table/len/row delta-splice -> state gather -> decode (KV
        append inside) -> state scatter-back -> argmax; the tables, lens
        and row indices stay on the device between steps and nothing
        here waits for the host."""
        _splice(resident, upd)
        tables, lens, rows = (r[:self.slots] for r in resident)
        c = self.cache
        logits = self._step_rows(
            params, tokens, PagedKVCache(c.k_pool, c.v_pool, tables, lens,
                                         c.config), rows)
        return torch.argmax(logits, dim=-1)

    def prefill(self, params, batch):
        """One padded call writes BOTH disciplines: paged KV lands in
        each row's private blocks (padding scatters to the kv sink) and
        the recurrent state rows scatter into the state pool."""
        # eager, no prefill graph: the reference jits only the hybrid's
        # fused decode, never its prefill
        cfg = self.cache.config
        lens = [req.tokens_held for _, req, _ in batch]
        S = -(-max(lens) // self._pad) * self._pad
        toks = np.zeros((len(batch), S), np.int64)
        tables = np.full((len(batch), cfg.max_blocks_per_seq), self.sink,
                         np.int32)
        for row, (_, req, _) in enumerate(batch):
            toks[row, : lens[row]] = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.generated, np.int64)])
            tbl = self.mgr.device_table(req.rid)
            keep = tbl != NULL_BLOCK
            tables[row, keep] = tbl[keep]
        view = PagedKVCache(self.cache.k_pool, self.cache.v_pool,
                            self._dev(tables),
                            self._dev(np.zeros(len(batch), np.int32)), cfg)
        conv, ssd = self.model.init_recurrent(len(batch), device=self.device)
        last, state = self.model.prefill(
            params, self._dev(toks),
            self._state_cls(conv, ssd, view),
            self._dev(np.asarray(lens, np.int32)))
        idx = np.asarray([self.state_mgr.row(req.rid)
                          for _, req, _ in batch], np.int64)
        self.state_mgr.pool[self._dev(idx)] = \
            self.model.state_to_rows(state.conv, state.ssd)
        nxt = torch.argmax(last, dim=-1).cpu().numpy()   # completion
        return nxt, sum(lens)

    # -- audit --
    def check_consistency(self, running) -> None:
        for mgr, sink in ((self.mgr, self.sink),
                          (self.state_mgr, self.state_sink)):
            alloc = mgr.allocator
            assert (alloc.num_used + alloc.num_free + alloc.num_held
                    == alloc.num_blocks)
            assert alloc.refcount(sink) == 1
            self.arena.check_registry(mgr.pool_class)
        bt = self.block_tokens
        lens = self.cache.seq_lens.cpu().numpy()
        for slot, req in running.items():
            tbl = self.mgr.block_ids(req.rid)
            assert len(tbl) * bt >= req.tokens_held
            assert lens[slot] == req.tokens_held
            assert len(self.state_mgr.mapping(req.rid)) == 1
        if self.resident and not self._all_dirty:
            dev = self.cache.block_tables.cpu().numpy()
            rows_dev = self._rows_dev.cpu().numpy()
            for slot, req in running.items():
                if slot in self._dirty:
                    continue
                want = self.mgr.device_table(req.rid)
                assert np.array_equal(dev[slot], want), (
                    f"slot {slot}: resident KV table diverged")
                assert rows_dev[slot] == self.state_mgr.row(req.rid), (
                    f"slot {slot}: resident state row diverged")
        transfers = self.arena.transfers
        for mgr, store in ((self.mgr, self.store),
                           (self.state_mgr, self.state_store)):
            transit = set(transfers.in_transit(mgr.pool_class))
            assert len(store) + len(transit) == len(mgr.swapped)


def _resident_cache(kvcfg, slots: int, sink: int, device):
    """(a cache whose tables and lengths are views of the first ``slots``
    rows, the resident (tables, lengths) with one scratch row more).  They
    START all-sink / length-0: a created cache fills tables with NULL
    (-1), so an untouched empty slot's padded decode write would
    otherwise land in clamped block 0."""
    full = PagedKVCache.create(kvcfg, slots + 1, device=device)
    full.block_tables.fill_(sink)
    full.seq_lens.zero_()
    cache = dataclasses.replace(full, block_tables=full.block_tables[:slots],
                                seq_lens=full.seq_lens[:slots])
    return cache, (full.block_tables, full.seq_lens)


def _splice(resident, upd) -> None:
    """Write the update entries into the resident tensors, in place: a
    pad entry's slot is the scratch row, so it is dropped on the device
    (the reference's ``.at[upd_slots].set(..., mode="drop")``)."""
    upd_slots, *values = upd
    if upd_slots.numel():
        idx = upd_slots.long()
        for r, v in zip(resident, values):
            r.index_copy_(0, idx, v.to(r.dtype))


@dataclasses.dataclass(frozen=True)
class SupportedArchitecture:
    """One registry row: model family -> cache discipline -> pools."""
    key: str                 # family or ssm kind this row matches
    strategy: type           # CacheStrategy subclass
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
        "mamba2", ConstantStateStrategy, ("state",),
        "pure SSM (mamba2): one constant state block per sequence, "
        "exact footprint, zero watermark pressure"),
    SupportedArchitecture(
        "hybrid", CompositeStrategy, ("kv", "state"),
        "zamba2 hybrid: paged KV for the shared-attention streams + "
        "constant state for the Mamba2 backbone"),
    SupportedArchitecture(
        "audio", CompositeStrategy, ("kv", "xattn"),
        "whisper: paged self-attention KV + read-only cross-attention "
        "segment (deposit once at encode, COW-share to decode beams)",
        served=False),
    SupportedArchitecture(
        "rwkv6", ConstantStateStrategy, ("state",),
        "RWKV6: one constant state block per sequence (shift vectors + "
        "wkv matrix state), length-masked padded prefill"),
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
                   num_blocks: int, pool_prefix: str = "",
                   state_blocks: Optional[int] = None,
                   device="cuda") -> CacheStrategy:
    """Resolve and construct the model's strategy over ``arena``;
    ``pool_prefix`` namespaces its pool classes and ``state_blocks``
    sizes the composite strategy's state pool (default 2 * slots + 2)."""
    row = resolve(model)
    if not row.served:
        raise NotImplementedError(
            f"architecture {row.key!r} is registered but not servable: "
            f"{row.description}")
    if getattr(model.cfg, "num_image_tokens", 0):
        raise NotImplementedError(
            f"{model.cfg.name}: an image-prefixed model needs image_embeds "
            f"at prefill, and the engine passes a model its prompt tokens "
            f"only")
    kw = dict(arena=arena, slots=slots, max_seq=max_seq,
              num_blocks=num_blocks, pool_prefix=pool_prefix, device=device)
    if row.strategy is CompositeStrategy:
        kw["state_blocks"] = state_blocks
    return row.strategy(model, **kw)
