"""Arrays-as-trees (Siebert-style), the paper's replacement for large
contiguous arrays, on PyTorch tensors.

Layout (paper Fig. 1): data lives ONLY in fixed-size leaf blocks; interior
nodes are fixed-size blocks of ``int32`` child ids.  A tree of depth ``d``
has ``d - 1`` levels of interior nodes.  With the paper's 32 KB nodes a
depth-3 tree addresses ~536 GB.

Two access disciplines, mirroring the paper's Table 2:

  * **naive** -- every element access walks root -> leaf (depth memory
    gathers per element): ``get_naive``, ``scan_sum_naive``.
  * **iterator** -- the paper's software-PTW-cache: resolve each *leaf*
    once (``leaf_table``), then stream ``leaf_size`` elements with pure
    pointer arithmetic.  ``to_dense`` and ``scan_sum_iter`` do this
    through the hand-written kernels ``tree_gather`` and
    ``tree_block_sum`` (``kernels/ops.py``), which read each leaf's id
    once per CTA and stream the leaf.

Differences from the reference (``repro.core.treearray``):

  * A plain dataclass of tensors, not a pytree.  ``set`` and ``add``
    update ``leaves`` IN PLACE (``index_put_``) and return the tree, so
    a caller holding the tree sees the write; the reference returns a
    new tree and leaves the old one as it was.
  * ``scan_sum_naive`` walks every element in one vectorised
    ``get_naive(arange(length))`` and sums the result: the same work (a
    full walk per element), done in bulk.  The reference runs a
    sequential ``fori_loop`` of one walk per element, which eager
    PyTorch would pay one launch per element for.
  * Element-index math is int64 (the reference's docstring promises it,
    but its code casts to int32; the two agree below 2^31 elements).

Placement is the reference's: for one ``shuffle_seed`` (or one
allocator or arena state) ``leaves``, ``nodes`` and ``root_leaf`` equal
the reference's element for element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.mem import NULL_BLOCK, Arena, BlockAllocator, Mapping


def tree_depth_for(length: int, leaf_size: int, fanout: int) -> int:
    """Minimum depth covering ``length`` elements (paper footnote 1)."""
    if length <= leaf_size:
        return 1
    leaves = math.ceil(length / leaf_size)
    depth = 1
    cover = 1
    while cover < leaves:
        cover *= fanout
        depth += 1
    return depth


@dataclasses.dataclass(eq=False)
class TreeArray:
    """A 1-D array of ``length`` elements stored as a radix tree of blocks.

    Fields
    ------
    leaves : (num_leaf_blocks, leaf_size) data pool (only ``length``
        elements are meaningful; the last leaf's padding is zero).
    nodes  : list over interior levels, root first.  ``nodes[0]`` has
        shape (1, fanout); level ``l`` has shape (n_l, fanout) of int32
        child ids into level ``l+1`` (or into ``leaves`` for the last
        interior level).  Empty list when depth == 1.
    root_leaf : 0-d int32 leaf id, used only when depth == 1.
    arena_mapping : the radix ``Mapping`` the leaves were drawn through
        when the tree was built on an ``Arena`` (``free()`` it to return
        them), else None.
    """

    leaves: torch.Tensor
    nodes: List[torch.Tensor]
    root_leaf: torch.Tensor
    length: int
    leaf_size: int
    fanout: int
    depth: int
    arena_mapping: Optional[Mapping] = None

    # -- constructors --------------------------------------------------
    @classmethod
    def from_dense(cls, x, leaf_size: int = 8192, fanout: int = 8192,
                   allocator: Optional[BlockAllocator] = None,
                   arena: Optional[Arena] = None,
                   pool_class: str = "tree",
                   owner=None,
                   shuffle_seed: Optional[int] = None,
                   device="cuda") -> "TreeArray":
        """Build a tree holding ``x`` (1-D; a numpy array or a tensor) on
        ``device``.

        ``leaf_size`` is in *elements*; the paper's 32 KB block with f32
        data is leaf_size=8192 (and fanout 8192 for 4-byte ids).  If
        ``arena`` is given, leaf blocks are drawn from that pool class
        of the shared ``repro_torch.mem.Arena`` through a radix
        ``Mapping`` (attached as ``arena_mapping``).  The ``allocator``
        argument draws raw ids instead.  ``shuffle_seed`` permutes leaf
        placement with numpy's ``RandomState`` to emulate a fragmented
        physical memory (the paper's whole point is that this must not
        matter).
        """
        dev = resolve_device(device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = torch.as_tensor(x).reshape(-1).to(dev)
        n = x.shape[0]
        depth = tree_depth_for(max(n, 1), leaf_size, fanout)
        num_leaves = max(1, math.ceil(n / leaf_size))

        mapping = None
        if arena is not None:
            if pool_class not in arena.pool_classes:
                raise KeyError(
                    f"register pool class {pool_class!r} on the arena "
                    f"before building trees from it")
            mapping = arena.mapping(pool_class,
                                    owner if owner is not None else "tree",
                                    kind="radix")
            leaf_ids = np.array(mapping.append_blocks(num_leaves),
                                dtype=np.int32)
            pool_blocks = arena.num_blocks(pool_class)
        elif allocator is not None:
            leaf_ids = np.array(allocator.alloc_many(num_leaves),
                                dtype=np.int32)
            pool_blocks = allocator.num_blocks
        else:
            leaf_ids = np.arange(num_leaves, dtype=np.int32)
            pool_blocks = num_leaves
            if shuffle_seed is not None:
                rng = np.random.RandomState(shuffle_seed)
                leaf_ids = rng.permutation(pool_blocks)[:num_leaves]
                leaf_ids = leaf_ids.astype(np.int32)

        pad = num_leaves * leaf_size - n
        xp = x if pad == 0 else torch.cat([x, x.new_zeros(pad)])
        # distinct ids: when they cover the whole pool every block is
        # written below, so the pool need not be zeroed first
        make = torch.empty if pool_blocks == num_leaves else torch.zeros
        leaves = make((pool_blocks, leaf_size), dtype=x.dtype, device=dev)
        leaves.index_copy_(0, torch.from_numpy(leaf_ids).to(dev).long(),
                           xp.view(num_leaves, leaf_size))

        nodes: List[torch.Tensor] = []
        if depth == 1:
            root = int(leaf_ids[0])
        else:
            root = NULL_BLOCK
            # Build interior levels bottom-up: ids of level l+1 grouped by
            # fanout form level l.
            child_ids = leaf_ids
            levels: List[np.ndarray] = []
            for _ in range(depth - 1):
                n_nodes = max(1, math.ceil(len(child_ids) / fanout))
                padded = np.full(n_nodes * fanout, NULL_BLOCK, dtype=np.int32)
                padded[: len(child_ids)] = child_ids
                levels.append(padded.reshape(n_nodes, fanout))
                child_ids = np.arange(n_nodes, dtype=np.int32)
            levels.reverse()  # root first
            assert levels[0].shape[0] == 1
            nodes = [torch.from_numpy(l).to(dev) for l in levels]
        root_leaf = torch.tensor(root, dtype=torch.int32, device=dev)
        return cls(leaves, nodes, root_leaf, n, leaf_size, fanout, depth,
                   mapping)

    # -- address resolution ----------------------------------------------
    def _index(self, elem_idx) -> torch.Tensor:
        return torch.as_tensor(elem_idx, device=self.leaves.device).long()

    def _leaf_of(self, elem_idx: torch.Tensor) -> torch.Tensor:
        """Walk the tree: logical element index -> physical leaf id
        (int32, the shape of ``elem_idx``).

        This is the software page-table walk.  ``elem_idx`` may be any
        shape; the walk vectorizes.  Cost: ``depth - 1`` gathers.
        """
        idx = self._index(elem_idx) // self.leaf_size   # logical leaf no.
        if self.depth == 1:
            return self.root_leaf.expand(idx.shape)
        node = torch.zeros_like(idx)  # root is node 0 of level 0
        for level in range(self.depth - 1):
            # stride of one child subtree at this level, in logical leaves
            stride = self.fanout ** (self.depth - 2 - level)
            digit = (idx // stride) % self.fanout
            node = self.nodes[level][node, digit].long()
        return node.to(torch.int32)  # leaf id

    def _address(self, elem_idx):
        """Flat (leaf id, offset) int64 index vectors of ``elem_idx``."""
        idx = self._index(elem_idx).reshape(-1)
        return self._leaf_of(idx).long(), idx % self.leaf_size

    # -- element access ----------------------------------------------------
    def get_naive(self, elem_idx) -> torch.Tensor:
        """Full tree walk per access (paper's 'Naive' rows)."""
        shape = self._index(elem_idx).shape
        leaf, off = self._address(elem_idx)
        return self.leaves[leaf, off].reshape(shape)

    def _scatter(self, elem_idx, value, accumulate: bool) -> "TreeArray":
        leaf, off = self._address(elem_idx)
        v = torch.as_tensor(value, dtype=self.leaves.dtype,
                            device=self.leaves.device)
        v = torch.broadcast_to(v, self._index(elem_idx).shape).reshape(-1)
        self.leaves.index_put_((leaf, off), v, accumulate=accumulate)
        return self

    def set(self, elem_idx, value) -> "TreeArray":
        """``x[elem_idx] = value``, in place; returns the tree."""
        return self._scatter(elem_idx, value, accumulate=False)

    def add(self, elem_idx, value) -> "TreeArray":
        """Scatter-add (GUPS update), in place; returns the tree.
        Repeated indices all add."""
        return self._scatter(elem_idx, value, accumulate=True)

    # -- iterator discipline -------------------------------------------
    def leaf_table(self) -> torch.Tensor:
        """Resolve every logical leaf id once: (num_logical_leaves,) int32.

        This is the iterator optimization hoisted to its limit -- the
        flattened 'page table' that the streaming kernels read one id of
        per CTA.  Cost: one tree walk per *leaf*, amortized over
        leaf_size elements.
        """
        first_elems = torch.arange(self.num_logical_leaves,
                                   device=self.leaves.device) * self.leaf_size
        return self._leaf_of(first_elems).contiguous()

    def to_dense(self) -> torch.Tensor:
        """Gather the logical array (iterator-ordered full scan) through
        the ``tree_gather`` kernel."""
        blocks = ops.tree_gather(self.leaves, self.leaf_table())
        return blocks.reshape(-1)[: self.length]

    def scan_sum_iter(self) -> torch.Tensor:
        """Linear scan (sum) with the iterator discipline: one walk per
        leaf, then streaming reads (paper Table 2 'Linear Scan: Iter').
        Full leaves are summed by the ``tree_block_sum`` kernel; the last
        leaf, when partial, is summed over its ``length`` elements only,
        so its padding is excluded, not assumed to be zero.  Returns a
        0-d float32 tensor."""
        table = self.leaf_table()
        tail = self.length - (table.shape[0] - 1) * self.leaf_size
        if tail == self.leaf_size:
            return ops.tree_block_sum(self.leaves, table).sum()
        total = ops.tree_block_sum(self.leaves, table[:-1]).sum()
        last = self.leaves.index_select(0, table[-1:].long())[0, :tail]
        return total + last.float().sum()

    def scan_sum_naive(self) -> torch.Tensor:
        """Linear scan (sum) with a full tree walk per element (paper
        Table 2 'Linear Scan: Naive'), all walks in one vectorised call
        (see the module docstring).  Returns a 0-d float32 tensor."""
        idx = torch.arange(self.length, device=self.leaves.device)
        return self.get_naive(idx).float().sum()

    def gather_iter(self, elem_idx) -> torch.Tensor:
        """Vectorized random gather: the 'accelerated tree traversal' the
        paper suggests in §4.4 -- resolves leaves in bulk (one vector walk)
        instead of per element.  Same result as get_naive."""
        return self.get_naive(elem_idx)  # vector walk is already bulk

    # -- stats --------------------------------------------------------
    @property
    def num_logical_leaves(self) -> int:
        return max(1, math.ceil(self.length / self.leaf_size))

    @property
    def overhead_bytes(self) -> int:
        return sum(int(n.numel()) * 4 for n in self.nodes)
