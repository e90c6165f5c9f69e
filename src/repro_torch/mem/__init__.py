"""repro_torch.mem -- the unified software address space.

The PyTorch package's copy of ``repro.mem``: one ``Arena`` behind every
block-backed subsystem, typed ``Lease`` handles, ``Mapping`` page tables
with ``fork``/``ensure_writable``/``migrate`` as the mutation verbs, a
host swap tier of CPU tensors, pressure-time reclaim, ``compact()`` and
the multi-queue transfer plane behind every block copy and swap, and
the live-migration and handoff verbs over it (``migrate.py``).  The
block bookkeeping is device-free and identical to the reference; only
the transfer executors touch tensors, through ``kernels/ops.py``.
"""

from repro_torch.mem.arena import Arena, LeaseRevokedError
from repro_torch.mem.blockpool import (NULL_BLOCK, BlockAllocator,
                                       OutOfBlocksError)
from repro_torch.mem.lease import (COW_SHARED, EXCLUSIVE, IN_FLIGHT, PINNED,
                                   Lease)
from repro_torch.mem.mapping import DEVICE, FLAT, HOST, RADIX, Mapping
from repro_torch.mem.migrate import (BlockBundle, MigrationSession,
                                     adopt_payload, export_mapping)
from repro_torch.mem.stats import ArenaStats, PoolClassStats
from repro_torch.mem.transfer import (BACKGROUND, D2D, D2H, DIRECTIONS, H2D,
                                      LANES, URGENT, Fence, QueueSet,
                                      TransferEngine, TransferPlan,
                                      TransferQueue, TransferStats,
                                      UnfencedReadError)

__all__ = [
    "Arena", "LeaseRevokedError",
    "BlockAllocator", "NULL_BLOCK", "OutOfBlocksError",
    "Lease", "EXCLUSIVE", "COW_SHARED", "PINNED", "IN_FLIGHT",
    "Mapping", "FLAT", "RADIX", "DEVICE", "HOST",
    "MigrationSession", "BlockBundle", "export_mapping", "adopt_payload",
    "ArenaStats", "PoolClassStats",
    "QueueSet", "TransferEngine", "TransferQueue", "TransferPlan",
    "TransferStats", "Fence", "UnfencedReadError",
    "D2D", "D2H", "H2D", "DIRECTIONS", "URGENT", "BACKGROUND", "LANES",
]
