"""Compatibility shim: the block allocator lives in ``repro_torch.mem``.

The unified software address space (``repro_torch.mem``) owns the
physical-memory layer: ``BlockAllocator`` (free list + refcounts).
Every block-backed client (``PagedKVManager``, ``TreeArray``,
``BlockStack``) allocates through one shared ``repro_torch.mem.Arena``;
this module only re-exports the names, as the reference's
``core/blockpool.py`` does.  The reference also re-exports
``BlockPool``, its device arena of fixed blocks; this package has no
such class -- each client holds its pool as a tensor of its own
(``PagedKVCache``'s pools, ``TreeArray.leaves``).
"""

from repro_torch.mem.blockpool import (NULL_BLOCK, BlockAllocator,
                                       OutOfBlocksError)

__all__ = ["BlockAllocator", "NULL_BLOCK", "OutOfBlocksError"]
