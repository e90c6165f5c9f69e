"""Core: the paper's software memory management on PyTorch tensors --
the block allocator's names, TreeArray (arrays as trees of blocks),
the paged KV cache, and the split stack (host and device)."""

from repro_torch.core.blockpool import (BlockAllocator, NULL_BLOCK,
                                        OutOfBlocksError)
from repro_torch.core.treearray import TreeArray, tree_depth_for
from repro_torch.core.paged_kv import (PagedKVCache, PagedKVConfig,
                                       PagedKVManager)
from repro_torch.core.stack import BlockStack, DeviceBlockStack

__all__ = [
    "BlockAllocator", "NULL_BLOCK", "OutOfBlocksError",
    "TreeArray", "tree_depth_for",
    "PagedKVCache", "PagedKVConfig", "PagedKVManager",
    "BlockStack", "DeviceBlockStack",
]
