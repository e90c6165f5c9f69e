"""Block-table utilities: deep tables and compaction.

A per-sequence block table is a depth-1 tree.  When a sequence's table
itself no longer fits one block (long_500k: 524288 tokens / 64-token
blocks = 8192 ids = exactly one 32 KB block of int32 -- the paper's
magnitude argument holds up remarkably well), tables become depth-2
trees; ``deep_table``/``resolve_deep`` implement that without changing
the pool.

Compaction: with fixed blocks there is NO external fragmentation (the
paper's point), so "defrag" only means migrating live blocks to a dense
prefix so a shrinking pool can return arena memory -- a pure block copy
plan plus a table rewrite (``Arena.compact``), never a data-structure
rebuild.

Host-side numpy, identical to the reference's module.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.mem.blockpool import NULL_BLOCK, BlockAllocator


def pack_table(blocks: Sequence[int], capacity: int) -> np.ndarray:
    t = np.full(capacity, NULL_BLOCK, np.int32)
    t[: len(blocks)] = np.asarray(blocks, np.int32)
    return t


def deep_table(blocks: Sequence[int], ids_per_block: int,
               allocator: BlockAllocator) -> Tuple[np.ndarray, List[int]]:
    """Split a long table into table-blocks; return (root, table_block_ids).

    root[i] = id of the table-block holding ids [i*ipb, (i+1)*ipb).
    Table blocks are drawn from the same allocator as data blocks -- one
    arena, one block size, as in the paper.
    """
    ipb = ids_per_block
    n = (len(blocks) + ipb - 1) // ipb
    tb_ids = allocator.alloc_many(max(1, n))
    root = np.asarray(tb_ids, np.int32)
    return root, tb_ids


def resolve_deep(root: np.ndarray, table_storage: np.ndarray,
                 logical_block: np.ndarray, ids_per_block: int) -> np.ndarray:
    """Two-level resolve: logical block no -> physical data block id.

    table_storage: (num_blocks, ids_per_block) int32 view of the arena's
    table blocks.  Vectorized -- this is the same walk TreeArray does.
    """
    tb = root[logical_block // ids_per_block]
    return table_storage[tb, logical_block % ids_per_block]


def compaction_plan(live_blocks: Sequence[int]) -> List[Tuple[int, int]]:
    """Plan (src, dst) copies moving live blocks to the dense prefix.

    Returns a minimal move list: blocks already inside the prefix stay.
    """
    live = sorted(set(int(b) for b in live_blocks))
    n = len(live)
    prefix = set(b for b in live if b < n)
    holes = [i for i in range(n) if i not in prefix]
    movers = [b for b in live if b >= n]
    assert len(holes) == len(movers)
    return list(zip(movers, holes))


def apply_compaction(tables: Dict[int, List[int]],
                     plan: List[Tuple[int, int]]) -> None:
    """Rewrite host tables after the device executed the copy plan."""
    remap = dict(plan)
    for seq, blocks in tables.items():
        tables[seq] = [remap.get(b, b) for b in blocks]
