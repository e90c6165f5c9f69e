"""Live migration of an Arena between engines: incremental pre-copy +
stop-and-copy, and the block-handoff bundles behind prefill/decode
disaggregation.

Counterpart of ``repro.mem.migrate``.  Because every payload move is
already a transfer-plane plan and every table an id-indirected
``Mapping``, moving a serving engine's memory to another engine needs no
new device mechanism -- only a dirty-tracking loop over the verbs that
already exist:

  * **pre-copy rounds** (``MigrationSession.begin_round`` /
    ``collect_round``): gather the blocks whose write generation changed
    since their last copy, on the BACKGROUND d2h lane, while decode
    keeps running.  Gathers of live blocks (refcount > 0) take no
    allocator holds -- they are pure reads;
  * **dirty tracking**: ``BlockAllocator`` keeps a per-block
    write-generation counter bumped by every writer (COW fulfilment
    copies, swap-in scatters, fresh allocations, the strategies'
    per-step decode barrier).  A block is dirty when its current
    generation differs from the one recorded at its last copy;
  * **convergence**: with decode running the dirty set never reaches
    zero; it CONVERGES when it stops shrinking.  On paged KV the residue
    is one tail block per running sequence; on a constant-state pool
    every decode rewrites each running row's whole block, so the residue
    is every running row;
  * **stop-and-copy** (``finalize``): with the engine paused between
    steps, re-gather the dirty tail, assemble the full device payload
    from the pre-copied store, and write one ``Arena.snapshot`` with
    ``device_payloads``.

Host payloads are CPU tensors (pinned when the pools live on a CUDA
device; numpy has no bfloat16).  The store keeps each block's slices as
copies, so it never holds a round's whole gather buffer alive.

``export_mapping``/``adopt_payload`` reuse the same gather/scatter pair
for ONE mapping: the prefill/decode-disaggregation handoff
(``serve/disagg.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.mem.arena import Arena
from repro_torch.mem.mapping import DEVICE, Mapping
from repro_torch.mem.transfer import BACKGROUND

__all__ = ["MigrationSession", "BlockBundle", "export_mapping",
           "adopt_payload"]


def _live_device_ids(arena: Arena, cls: str) -> List[int]:
    """Ordered union of block ids named by device-resident mappings."""
    out: List[int] = []
    seen = set()
    for m in arena._cls(cls).mappings:
        if m.placement != DEVICE:
            continue
        for b in m.block_ids():
            if b not in seen:
                seen.add(b)
                out.append(b)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MigrationSession:
    """Incremental live migration of every executor-backed pool class.

    Usage (the engine keeps stepping between rounds)::

        sess = MigrationSession(engine.arena)
        while not sess.converged():
            sess.begin_round()       # background gathers enqueued
            engine.step()            # decode overlaps the pre-copy
            sess.collect_round()     # payload landed; record gens
        sess.finalize(path)          # short stop-and-copy + snapshot

    ``migration_report()`` exposes rounds, blocks/bytes per round and
    the stop-and-copy tail size.
    """

    def __init__(self, arena: Arena,
                 pool_classes: Optional[List[str]] = None,
                 max_rounds: int = 8):
        self.arena = arena
        self.classes = [c for c in (pool_classes or arena.pool_classes)
                        if arena.transfers.has_executor(c)]
        self.max_rounds = int(max_rounds)
        #: block id -> write generation recorded at its last copy
        self._copied_gen: Dict[str, Dict[int, int]] = {
            c: {} for c in self.classes}
        #: block id -> per-stream host slices from its last copy
        self._store: Dict[str, Dict[int, Tuple]] = {
            c: {} for c in self.classes}
        self._rounds: List[dict] = []
        self._pending: Optional[Dict[str, Tuple]] = None
        self._stop = {"blocks": 0, "bytes": 0}
        self.pause_steps = 0
        self.finalized = False

    # -- dirty tracking --------------------------------------------------
    def _dirty_ids(self, cls: str) -> Tuple[List[int], List[int]]:
        alloc = self.arena._cls(cls).allocator
        ids, gens = [], []
        for b in _live_device_ids(self.arena, cls):
            g = alloc.write_gen(b)
            if self._copied_gen[cls].get(b) != g:
                ids.append(b)
                gens.append(g)
        return ids, gens

    def dirty_count(self) -> int:
        return sum(len(self._dirty_ids(c)[0]) for c in self.classes)

    def converged(self) -> bool:
        """The dirty set stopped shrinking (the residue is the working
        set -- under live decode it never reaches zero), or the round
        budget ran out."""
        if len(self._rounds) >= self.max_rounds:
            return True
        if self._rounds and self._rounds[-1]["blocks"] == 0:
            return True
        if len(self._rounds) < 2:
            return False
        return self._rounds[-1]["blocks"] >= self._rounds[-2]["blocks"]

    def _land(self, cls: str, owner: str, ids: List[int],
              gens: List[int]) -> int:
        """Move a landed gather of ``ids`` from the host tier into the
        per-block store (one copied slice per block and stream, so the
        store does not keep the gather's buffer alive); returns bytes."""
        streams = self.arena.host_take(cls, owner)
        layered = self.arena.transfers.is_layered(cls)
        nbytes = 0
        for i, (b, g) in enumerate(zip(ids, gens)):
            sl = tuple(None if s is None
                       else (s[:, i] if layered else s[i]).clone()
                       for s in streams)
            self._store[cls][b] = sl
            self._copied_gen[cls][b] = g
            nbytes += sum(_nbytes(x) for x in sl if x is not None)
        return nbytes

    # -- pre-copy rounds -------------------------------------------------
    def begin_round(self) -> int:
        """Enqueue background gathers of every dirty block; returns how
        many blocks this round will copy.  The caller keeps stepping the
        engine -- its dispatch/fence phases execute the gathers."""
        if self._pending is not None:
            raise RuntimeError("collect_round() the previous round first")
        if self.finalized:
            raise RuntimeError("session already finalized")
        self._pending = {}
        total = 0
        for cls in self.classes:
            ids, gens = self._dirty_ids(cls)
            if not ids:
                continue
            owner = f"__migrate__/{cls}/{len(self._rounds)}"
            self.arena.transfers.enqueue_swap_out(
                cls, owner, ids, kind="migrate-out", lane=BACKGROUND)
            self._pending[cls] = (owner, ids, gens)
            total += len(ids)
        return total

    def collect_round(self) -> dict:
        """Land this round's payloads into the per-block store and
        record the generations they were copied at."""
        if self._pending is None:
            raise RuntimeError("no round in flight; begin_round() first")
        report = {"round": len(self._rounds), "blocks": 0, "bytes": 0}
        for cls, (owner, ids, gens) in self._pending.items():
            if not self.arena.host_contains(cls, owner):
                self.arena.transfers.drain()
            report["bytes"] += self._land(cls, owner, ids, gens)
            report["blocks"] += len(ids)
        self._pending = None
        self._rounds.append(report)
        return report

    # -- stop-and-copy ---------------------------------------------------
    def finalize(self, path: str) -> dict:
        """The short pause: drain, re-copy the dirty tail synchronously,
        assemble the full device payload from the store and write the
        snapshot.  Runs between engine steps.  Returns the stop-and-copy
        report ``{"blocks": n, "bytes": n}``."""
        if self._pending is not None:
            raise RuntimeError("collect_round() the in-flight round first")
        self.arena.transfers.drain()
        for cls in self.classes:
            ids, gens = self._dirty_ids(cls)
            if not ids:
                continue
            owner = f"__migrate__/{cls}/final"
            self.arena.transfers.enqueue_swap_out(
                cls, owner, ids, kind="migrate-out")
            self.arena.transfers.drain()
            self._stop["bytes"] += self._land(cls, owner, ids, gens)
            self._stop["blocks"] += len(ids)
        payloads: Dict[str, tuple] = {}
        for cls in self.classes:
            live = _live_device_ids(self.arena, cls)
            if not live:
                continue
            layered = self.arena.transfers.is_layered(cls)
            nstreams = len(self._store[cls][live[0]])
            streams = []
            for j in range(nstreams):
                parts = [self._store[cls][b][j] for b in live]
                streams.append(None if parts[0] is None else
                               torch.stack(parts, dim=1 if layered else 0))
            gens = [self._copied_gen[cls][b] for b in live]
            payloads[cls] = (live, tuple(streams), gens)
        self.pause_steps = max(self.pause_steps, 1)
        self.arena.snapshot(path, include_device=True,
                            device_payloads=payloads)
        self.finalized = True
        return dict(self._stop)

    # -- observability ---------------------------------------------------
    def migration_report(self) -> dict:
        return {
            "rounds": len(self._rounds),
            "blocks_per_round": [r["blocks"] for r in self._rounds],
            "bytes_per_round": [r["bytes"] for r in self._rounds],
            "precopy_blocks": sum(r["blocks"] for r in self._rounds),
            "precopy_bytes": sum(r["bytes"] for r in self._rounds),
            "stop_copy_blocks": self._stop["blocks"],
            "stop_copy_bytes": self._stop["bytes"],
            "pause_steps": self.pause_steps,
            "finalized": self.finalized,
        }


# ---------------------------------------------------------------------------
# block handoff: the prefill/decode-disaggregation transfer pattern
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockBundle:
    """One mapping's blocks as a transferable payload: what a prefill
    worker deposits and a decode worker adopts.  ``streams`` follow the
    pool class's executor layout (layered ``(L, n, *block)`` or flat
    ``(n, *block)``) as CPU tensors; ``None`` entries are passthrough
    streams."""

    pool_class: str
    nblocks: int
    streams: Tuple
    nbytes: int
    tenant: str = "default"


def export_mapping(arena: Arena, mapping: Mapping) -> BlockBundle:
    """Gather a device-resident mapping's blocks into a ``BlockBundle``
    and release the mapping -- the source side of the handoff.  The
    gather rides the transfer plane (kind ``handoff``, so swap ledgers
    ignore it) and the blocks return to the source pool."""
    if mapping.placement != DEVICE:
        raise ValueError("export of a host-resident mapping; migrate to "
                         "device first or hand over the host payload")
    cls = mapping.pool_class
    ids = mapping.block_ids()
    owner = f"__handoff__/{cls}/{Arena._tag_owner(mapping.owner)}"
    arena.transfers.enqueue_swap_out(cls, owner, ids, kind="handoff")
    arena.transfers.drain()
    streams = arena.host_take(cls, owner)
    nbytes = int(sum(_nbytes(s) for s in streams if s is not None))
    tenant = mapping.tenant
    mapping.free()
    return BlockBundle(cls, len(ids), tuple(streams), nbytes,
                       tenant=str(tenant))


def adopt_payload(arena: Arena, owner, bundle: BlockBundle,
                  pool_class: Optional[str] = None) -> Mapping:
    """Materialize a ``BlockBundle`` on (possibly different) fresh
    blocks of ``arena`` -- the destination side of the handoff.  The
    scatter rides the transfer plane and writes the pools in place; the
    returned mapping is device-resident and ready for
    ``PagedKVManager.adopt`` / ``ConstantStateManager.adopt``."""
    cls = pool_class if pool_class is not None else bundle.pool_class
    if not arena.transfers.has_executor(cls):
        raise RuntimeError(f"pool class {cls!r} has no executor on the "
                           f"adopting arena; build the engine first")
    m = arena.mapping(cls, owner, tenant=bundle.tenant)
    m.append_blocks(bundle.nblocks, pressure=True)
    key = f"__handoff__/{cls}/{Arena._tag_owner(owner)}"
    streams = tuple(None if s is None else arena._host_tensor(cls, s)
                    for s in bundle.streams)
    arena.host_deposit(cls, key, streams, bundle.nbytes)
    arena.transfers.enqueue_swap_in(cls, key, m.block_ids(),
                                    kind="handoff")
    arena.transfers.drain()
    return m
