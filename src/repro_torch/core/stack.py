"""BlockStack: the paper's split stack as a runtime data structure.

gcc's split-stack is x86 codegen; the *mechanism* is: on every push
(function call), a ~3-instruction check asks "does the current block have
room?"; almost always yes -> bump pointer; rarely no -> link a fresh
fixed-size block from the allocator.  Pop unlinks when a block empties.

In this framework the BlockStack backs host-side runtime structures that
grow unpredictably -- the serving scheduler's per-request scratch, swap
manifests, and the data pipeline's shard queues -- so that NOTHING in the
runtime ever asks the allocator for a large contiguous region.  In
this package it backs the serving scheduler's preempted-request stack.
``repro_torch.bench.stack`` reproduces Fig. 3's claim (check-on-push is
~2% typical, ~15% pathological) against a plain contiguous list.

The device-side variant (``DeviceBlockStack``) is a fixed-capacity
LIFO of int32 ids held as tensors, for free-lists that stay on the card.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.mem import Arena, BlockAllocator, Mapping


class BlockStack:
    """Host-side stack of Python scalars/objects in fixed-size blocks.

    Blocks are plain Python lists addressed by ids drawn from a shared
    allocator (ids only -- storage is per-stack), so many stacks share
    one arena without any contiguity assumption.  Pass ``arena`` (plus a
    registered ``pool_class``) to account the linked blocks against the
    unified ``repro_torch.mem.Arena`` through a flat ``Mapping``; the legacy
    ``allocator`` argument draws raw ids instead.
    """

    __slots__ = ("block_size", "_alloc", "_mapping", "_blocks",
                 "_block_ids", "_top", "_cur", "_off")

    def __init__(self, block_size: int = 4096,
                 allocator: Optional[BlockAllocator] = None,
                 arena: Optional[Arena] = None,
                 pool_class: str = "stack", owner="stack"):
        self.block_size = int(block_size)
        self._alloc = allocator
        self._mapping: Optional[Mapping] = (
            arena.mapping(pool_class, owner) if arena is not None else None)
        self._blocks: List[list] = []
        self._block_ids: List[int] = []
        self._top = 0          # total element count
        self._cur: Optional[list] = None   # cached current leaf (the
        self._off = 0          # paper's iterator/split-stack fast path)

    def __len__(self) -> int:
        return self._top

    def _grow(self) -> None:
        # the "rare path": link a new fixed-size block
        if self._mapping is not None:
            self._block_ids.append(self._mapping.append_blocks(1)[0])
        elif self._alloc is not None:
            self._block_ids.append(self._alloc.alloc())
        blk = [None] * self.block_size
        self._blocks.append(blk)
        self._cur = blk
        self._off = 0

    def _unlink_last(self) -> None:
        self._blocks.pop()
        if self._mapping is not None:
            self._mapping.pop_block()
            self._block_ids.pop()
        elif self._alloc is not None:
            self._alloc.free(self._block_ids.pop())

    def push(self, item: Any) -> None:
        # fast path: one compare (the split-stack space check) + store
        off = self._off
        if off == self.block_size or self._cur is None:
            blk_no = self._top // self.block_size
            if blk_no == len(self._blocks):
                self._grow()
            else:
                self._cur = self._blocks[blk_no]
                self._off = 0
            off = self._off
        self._cur[off] = item
        self._off = off + 1
        self._top += 1

    def pop(self) -> Any:
        if self._top == 0:
            raise IndexError("pop from empty BlockStack")
        off = self._off
        if off == 0:   # rare: step back into the previous block
            blk_no = (self._top - 1) // self.block_size
            # unlink emptied trailing blocks (one block hysteresis)
            while len(self._blocks) > blk_no + 1:
                self._unlink_last()
            self._cur = self._blocks[blk_no]
            off = self._top - blk_no * self.block_size
        item = self._cur[off - 1]
        self._cur[off - 1] = None
        self._off = off - 1
        self._top -= 1
        if self._top == 0:
            # fully drained: drop the hysteresis block too, so shared
            # arenas see a quiescent stack (leak invariant in tests)
            while self._blocks:
                self._unlink_last()
            self._cur = None
            self._off = 0
        return item

    def peek(self) -> Any:
        if self._top == 0:
            raise IndexError("peek of empty BlockStack")
        if self._off > 0:
            return self._cur[self._off - 1]
        blk, off = divmod(self._top - 1, self.block_size)
        return self._blocks[blk][off]

    def peek_n(self, k: int) -> List[Any]:
        """Top ``k`` items, top-of-stack first, without popping (the
        speculative resume window's read-only view).  Returns fewer when
        the stack holds fewer."""
        out = []
        for i in range(min(k, self._top)):
            blk, off = divmod(self._top - 1 - i, self.block_size)
            out.append(self._blocks[blk][off])
        return out

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)


class DeviceBlockStack:
    """Fixed-capacity int32 LIFO held as tensors: ``data`` (capacity,)
    and ``top`` (a 0-d int32 count), both on one device.

    ``push`` and ``pop`` return a new instance, as the reference's
    functional version does, and read ``top`` on the device (no host
    sync).  Unlike the reference, ``push`` writes ``data`` IN PLACE and
    the new instance shares it: an older instance sees the write in any
    slot at or above its own ``top`` (below it, nothing changes).
    """

    def __init__(self, data: torch.Tensor, top: torch.Tensor):
        self.data = data
        self.top = top

    @classmethod
    def full_of(cls, values, device="cuda") -> "DeviceBlockStack":
        dev = resolve_device(device)
        data = torch.as_tensor(values).to(dev, torch.int32).reshape(-1)
        # a copy of its own: push writes it in place
        return cls(data.clone(), torch.tensor(data.shape[0],
                                              dtype=torch.int32, device=dev))

    @classmethod
    def empty(cls, capacity: int, device="cuda") -> "DeviceBlockStack":
        dev = resolve_device(device)
        return cls(torch.zeros(capacity, dtype=torch.int32, device=dev),
                   torch.zeros((), dtype=torch.int32, device=dev))

    def push(self, v) -> "DeviceBlockStack":
        v = torch.as_tensor(v, dtype=torch.int32, device=self.data.device)
        self.data.index_put_((self.top.long().reshape(1),), v.reshape(1))
        return DeviceBlockStack(self.data, self.top + 1)

    def pop(self):
        """``(value, new stack)``: the 0-d top value and the stack
        without it."""
        v = self.data.index_select(0, (self.top.long() - 1).reshape(1))
        return v.reshape(()), DeviceBlockStack(self.data, self.top - 1)
