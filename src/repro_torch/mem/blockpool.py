"""Fixed-size block allocator: the paper's physical-memory manager.

The paper's OS hands out fixed-size blocks (32 KB) as the minimum
allocation unit and *never* promises large contiguous regions.  The
device pools are plain tensors of shape ``(num_blocks, *block_shape)``
(or ``(L, num_blocks, *block_shape)`` stacked over layers), and this
host-side ``BlockAllocator`` (free list + refcounts) plays the role of
the paper's simple OS memory manager.

Device code never sees pointers -- only ``int32`` block ids, which is
exactly the paper's "software page table" discipline.  Copy-on-write is
supported via refcounts so that block tables can alias blocks (used by
the serving engine for shared prefixes).

This module is device-free: it is the PyTorch package's own copy of
the reference allocator, and tests hold the two to identical ids.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

NULL_BLOCK = -1  # sentinel "unmapped" entry in block tables


class OutOfBlocksError(RuntimeError):
    """Raised when the pool has no free blocks (the paper's OOM analogue)."""


class BlockAllocator:
    """Host-side free-list allocator with refcounts (COW support).

    This is deliberately simple -- the paper argues a fixed-block OS
    allocator *can* be this simple because external fragmentation is
    impossible: every request is exactly one block.
    """

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount = np.zeros(num_blocks, dtype=np.int32)
        # block -> the DMA engine (transfer direction) holding it; the
        # per-engine discipline lets the transfer plane release one
        # engine's holds without fencing the others
        self._held: Dict[int, str] = {}
        # monotone per-block write-generation counter: every writer of a
        # block's payload (COW fulfilment copies, swap-in scatters,
        # append_token decode writes via the strategy barrier) bumps it.
        # Live migration diffs generations between pre-copy rounds to
        # find the dirty set -- the software analogue of dirty-page bits.
        self._write_gen = np.zeros(num_blocks, dtype=np.int64)

    # -- queries ---------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free) - len(self._held)

    @property
    def num_held(self) -> int:
        return len(self._held)

    def refcount(self, block: int) -> int:
        return int(self._refcount[block])

    def used_ids(self) -> np.ndarray:
        """Ascending ids of all currently allocated blocks."""
        return np.nonzero(self._refcount > 0)[0]

    def is_allocated(self, block: int) -> bool:
        return self._refcount[block] > 0

    # -- write generations (dirty tracking for live migration) ----------
    def note_write(self, blocks: Sequence[int]) -> None:
        """Record that the payload of ``blocks`` was (or is about to be)
        written.  Conservative pre-write bumps are fine: an extra copy in
        the next migration round is cheap; a missed one is corruption."""
        for b in blocks:
            if b != NULL_BLOCK:
                self._write_gen[b] += 1

    def write_gen(self, block: int) -> int:
        return int(self._write_gen[block])

    def write_gens(self, blocks: Sequence[int]) -> np.ndarray:
        return self._write_gen[np.asarray(blocks, dtype=np.int64)]

    # -- allocation ------------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocksError("block pool exhausted")
        b = self._free.pop()
        self._refcount[b] = 1
        # a fresh allocation is about to be written (prefill scatter,
        # growth, copy target): bump conservatively so a migration that
        # copied this id under a previous tenant re-copies it
        self._write_gen[b] += 1
        return b

    def alloc_many(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocksError(
                f"requested {n} blocks, only {len(self._free)} free"
            )
        return [self.alloc() for _ in range(n)]

    def share(self, block: int) -> int:
        """Increment refcount (a block-table aliases this block)."""
        if self._refcount[block] <= 0:
            raise ValueError(f"share of unallocated block {block}")
        self._refcount[block] += 1
        return block

    def free(self, block: int) -> None:
        if block == NULL_BLOCK:
            return
        if self._refcount[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._refcount[block] -= 1
        if self._refcount[block] == 0:
            self._free.append(block)

    # -- transfer-plane holds (per-engine) ------------------------------
    def hold(self, block: int, engine: str = "dma") -> None:
        """Remove a FREED block from the free list without allocating it.

        The transfer plane holds the vacated sources of an unfenced DMA
        (swap-out gather, compaction copy): the allocator let go of the
        ids, but the device still has to read them -- handing them out
        before the gather launches would let a prefill/scatter clobber
        the payload mid-flight.  Each hold is tagged with the DMA
        engine (direction) that will read the block -- since holds are
        released plan-by-plan as each per-direction queue dispatches,
        the tags attribute every outstanding hold to the engine
        responsible for it (``held_by_engine`` feeds ``ArenaStats``, so
        a stalled queue's pinned blocks are visible per engine).
        ``release_hold`` returns them.
        """
        if self._refcount[block] != 0 or block in self._held:
            raise ValueError(f"hold of non-free block {block}")
        self._free.remove(block)
        self._held[block] = engine

    def retag_hold(self, block: int, engine: str) -> None:
        """Move an existing hold to another engine (a later plan in a
        different queue became the block's last reader)."""
        if block not in self._held:
            raise ValueError(f"retag_hold of unheld block {block}")
        self._held[block] = engine

    def is_held(self, block: int) -> bool:
        return block in self._held

    def held_ids(self) -> set:
        return set(self._held)

    def held_by_engine(self) -> Dict[str, int]:
        """Outstanding holds per DMA engine (the ``ArenaStats``
        attribution surface: which queue is pinning vacated blocks)."""
        out: Dict[str, int] = {}
        for e in self._held.values():
            out[e] = out.get(e, 0) + 1
        return out

    def release_hold(self, block: int) -> None:
        if block not in self._held:
            raise ValueError(f"release_hold of unheld block {block}")
        del self._held[block]
        self._free.append(block)

    def fork_for_write(self, block: int) -> Tuple[int, bool]:
        """COW: return a private block id for writing.

        If refcount == 1 the caller already owns it exclusively; otherwise
        allocate a fresh block (caller must copy payload) and drop one ref
        on the shared one.  Returns (block_id, needs_copy).
        """
        if self._refcount[block] <= 0:
            raise ValueError(f"fork of unallocated block {block}")
        if self._refcount[block] == 1:
            return block, False
        fresh = self.alloc()
        self.free(block)
        return fresh, True

    # -- relocation (defrag / compaction) -------------------------------
    def relocate(self, plan: Sequence[Tuple[int, int]]) -> None:
        """Apply a (src, dst) move plan to the id space.

        Refcounts travel with blocks; the free list is rebuilt so the
        vacated sources become allocatable again.  The caller is
        responsible for (a) copying payloads src -> dst on device and
        (b) rewriting every table/lease that names a moved id -- the
        Arena's ``compact()`` does all three in one motion.
        """
        for s, d in plan:
            if self._refcount[s] <= 0:
                raise ValueError(f"relocate of unallocated block {s}")
            if self._refcount[d] != 0:
                raise ValueError(f"relocate into live block {d}")
            self._refcount[d] = self._refcount[s]
            self._refcount[s] = 0
            # generations travel with the payload; the d2d copy that
            # fulfils the plan bumps the destination when it executes.
            self._write_gen[d] = self._write_gen[s]
        self._free = [b for b in range(self.num_blocks - 1, -1, -1)
                      if self._refcount[b] == 0 and b not in self._held]

    def refcount_histogram(self) -> "np.ndarray":
        """histogram[r] = number of blocks currently at refcount r."""
        return np.bincount(self._refcount,
                           minlength=2).astype(np.int64)
