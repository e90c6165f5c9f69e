"""ArenaStats: the observability surface of the software address space.

One struct read by the serving stack's reports (``Engine.arena_stats``)
and by tests as leak invariants (every engine test must end with zero
non-pinned blocks used and an all-zero refcount histogram).

Per pool class:

  * blocks by owner and by placement (device leases vs host swap tier),
  * the refcount histogram (``histogram[r]`` = blocks at refcount ``r``;
    entries at r >= 2 are live COW sharing),
  * ``fragmentation``: ``1 - used / span`` where span is the highest
    used id + 1 -- 0.0 means the live blocks form a dense prefix (the
    state ``Arena.compact()`` restores),
  * ``table_locality``: mean over mappings of the fraction of logically
    adjacent block pairs that are physically adjacent -- the quantity
    that degrades as preemption/swap-in scatters tables, and the trigger
    (together with plentiful free blocks) for the defrag pass,
  * ``groups``: blocks used/free per dp pool group (contiguous id
    ranges) when the class was registered with ``dp_groups > 1``,
  * ``in_flight`` / ``held``: the transfer plane's discipline counters
    (leases awaiting an unfenced copy; vacated DMA sources the
    allocator may not reuse yet).

``ArenaStats.transfers`` embeds the ``TransferStats`` snapshot (plans
per direction, bytes moved, coalesced launches, overlapped host copies).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class PoolClassStats:
    name: str
    num_blocks: int
    num_free: int
    num_used: int
    pinned: int
    blocks_by_owner: Dict[str, int]
    host_blocks_by_owner: Dict[str, int]
    refcount_histogram: List[int]
    fragmentation: float
    table_locality: float
    mappings_by_kind: Dict[str, int]
    in_flight: int = 0
    held: int = 0
    #: outstanding holds attributed to the DMA engine (direction)
    #: responsible for them -- which queue is pinning vacated blocks
    held_by_engine: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    #: admission-enforced per-tenant block ceilings (empty = unlimited)
    quota_by_tenant: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: device + host blocks currently charged to each tenant
    blocks_by_tenant: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def host_blocks(self) -> int:
        return sum(self.host_blocks_by_owner.values())

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["host_blocks"] = self.host_blocks
        return d


@dataclasses.dataclass
class ArenaStats:
    classes: Dict[str, PoolClassStats]
    compactions: int = 0
    blocks_compacted: int = 0
    transfers: Optional[Dict] = None

    def __getitem__(self, name: str) -> PoolClassStats:
        return self.classes[name]

    def to_dict(self) -> dict:
        return {
            "compactions": self.compactions,
            "blocks_compacted": self.blocks_compacted,
            "transfers": self.transfers,
            "classes": {k: v.to_dict() for k, v in self.classes.items()},
        }
