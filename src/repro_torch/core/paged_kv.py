"""Paged KV cache: the paper's block-allocated memory applied to serving.

A decoding sequence's KV cache is the canonical "large, growing array"
that virtual memory used to make contiguous.  Here it is stored the
paper's way: fixed-size blocks of ``block_tokens`` tokens drawn from a
shared pool, addressed through a per-sequence **block table**.

Pools are stacked over layers (leading L axis); the model's Python loop
over layers hands each layer its ``pool[l]`` view.  One block id is
valid across all layers/heads -- the pool's trailing dims carry
(kv_heads, head_dim):

    (L, num_blocks, block_tokens, kv_heads, head_dim)

Unlike the reference's functional pytree, ``PagedKVCache`` holds
tensors that the model and the transfer plane update IN PLACE (the
block kernels and the decode kernel write into the pools); the block
tables and lengths are replaced wholesale or delta-scattered.
Three layouts: GQA/MQA keeps a (k, v) pair of pools; MLA's latent mode
(``PagedKVConfig.latent``) keeps ONE headless stream per token,
``kv_lora || k_rope``, shaped ``(L, NB, BT, latent_dim)``, with
``v_pool = None`` (the decode kernel reads V as the first ``kv_lora``
lanes of the same rows); the split-latent mode (``latent`` with
``latent_rope``, the reference's, which ``DecoderLM`` takes under
``mla_latent_tp``) keeps the two parts apart: ``k_pool`` the
``kv_lora`` stream ``(L, NB, BT, kv_lora)`` and ``v_pool`` the shared
rope keys ``(L, NB, BT, latent_rope)``, so that the lora stream can
split over the model axis on its last dimension while the rope stream
stays whole (``launch/steps.py``: a rank's ``k_pool`` then holds its
lora lanes).  On the model axis the one-stream latent pool is
replicated, and a GQA pool holds the KV heads its rank reads.

Data-parallel pool groups (``dp_groups``, the reference's): the block
dim splits into ``dp_groups`` contiguous ranges co-sharded with the
batch (rows split the same way), and the tables hold GROUP-LOCAL ids.
On a mesh each rank holds its group's range and rows, so its local ids
are already right (``launch/steps.py``).  On one device,
``PagedKVCache.global_ids`` turns them into pool ids in one place --
row b of group g adds ``g * NB / dp_groups``, NULL stays NULL -- before
any gather, scatter or kernel launch, so the kernels never see a group.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.mem import Arena, Mapping, NULL_BLOCK, OutOfBlocksError


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    num_layers: int
    kv_heads: int
    head_dim: int          # per-head dim; for MLA: latent_dim = kv_lora + rope
    block_tokens: int = 64
    num_blocks: int = 1024
    max_blocks_per_seq: int = 16
    latent: bool = False   # MLA: single stream, no separate V pool
    #: split-latent mode: ``k_pool`` holds the kv_lora stream (head_dim =
    #: kv_lora, splittable over the model axis), ``v_pool`` the shared
    #: rope keys of this width
    latent_rope: int = 0
    dtype: torch.dtype = torch.bfloat16
    #: data-parallel pool groups: tables hold ids local to their row's
    #: group (see the module docstring)
    dp_groups: int = 1

    def token_shape(self) -> Tuple[int, ...]:
        return (self.head_dim,) if self.latent else (self.kv_heads,
                                                     self.head_dim)

    def pool_shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.num_blocks, self.block_tokens,
                *self.token_shape())

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def v_shape(self) -> Optional[Tuple[int, ...]]:
        """The V pool's shape: the K pool's, the rope stream's (split
        latent mode) or None (one latent stream)."""
        if not self.latent:
            return self.pool_shape()
        if self.latent_rope:
            return (*self.pool_shape()[:-1], self.latent_rope)
        return None

    def swap_nbytes_per_block(self) -> int:
        """Device<->host bytes to move ONE block (all layers, all
        streams: k and v, the one latent stream, or the lora and rope
        streams).  A preempted sequence holding n blocks moves exactly
        n * this many bytes -- never a function of num_blocks."""
        per = int(np.prod(self.token_shape()))
        width = per if self.latent else 2 * per
        if self.latent and self.latent_rope:
            width += self.latent_rope
        return (self.num_layers * self.block_tokens * width
                * self.itemsize)


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV state: pools updated in place, tables/lens per step."""

    k_pool: torch.Tensor         # (L, NB, BT, KVH, HD) or (L, NB, BT, LAT)
    #: (L, NB, BT, KVH, HD); the rope stream (L, NB, BT, R) in split
    #: latent mode; None in one-stream latent mode
    v_pool: Optional[torch.Tensor]
    block_tables: torch.Tensor   # (B, max_blocks_per_seq) int32
    seq_lens: torch.Tensor       # (B,) int32 -- tokens already cached
    config: PagedKVConfig

    @classmethod
    def create(cls, config: PagedKVConfig, batch: int,
               device="cuda") -> "PagedKVCache":
        k = torch.zeros(config.pool_shape(), dtype=config.dtype,
                        device=device)
        vs = config.v_shape()
        v = None if vs is None else torch.zeros(vs, dtype=config.dtype,
                                                device=device)
        tables = torch.full((batch, config.max_blocks_per_seq), NULL_BLOCK,
                            dtype=torch.int32, device=device)
        lens = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cls(k, v, tables, lens, config)

    def global_ids(self, tables: torch.Tensor) -> torch.Tensor:
        """Pool ids for ``tables`` (B, W) of group-local ids, the rows
        split into ``dp_groups`` groups as the batch is: row b of group
        ``g = b // (B / dp_groups)`` adds ``g * num_blocks / dp_groups``
        and NULL entries stay NULL.  ``tables`` itself when there is one
        group."""
        dp = self.config.dp_groups
        if dp <= 1:
            return tables
        B = tables.shape[0]
        if B % dp or self.config.num_blocks % dp:
            raise ValueError(f"{B} rows and {self.config.num_blocks} blocks "
                             f"do not split into {dp} pool groups")
        rows = torch.arange(B, device=tables.device)
        off = ((rows // (B // dp)) * (self.config.num_blocks // dp)).to(
            tables.dtype)[:, None]
        return torch.where(tables >= 0, tables + off, tables)

    def write_prefill(self, k: torch.Tensor, v: Optional[torch.Tensor],
                      lengths: torch.Tensor) -> "PagedKVCache":
        """Bulk-write prompts IN PLACE.  k, v: (L, B, S, KVH, HD), the
        latent stream k (L, B, S, LAT) with v None, or in split latent
        mode the lora stream k (L, B, S, kv_lora) and the rope stream v
        (L, B, S, R); positions 0..S-1
        land in the first S // BT blocks of each row's table (NULL
        entries clamp to block 0, as in the reference).  Tokens beyond
        ``lengths[b]`` are written too (masked by seq_lens at read
        time).  With ``dp_groups`` a NULL entry clamps to block 0 of its
        row's group.  Returns the cache with seq_lens = lengths."""
        if (v is None) != (self.v_pool is None):
            raise ValueError("write_prefill: pass v exactly when the cache "
                             "has a V pool (v is None in one-stream latent "
                             "mode)")
        L, B, S = k.shape[:3]
        bt = self.config.block_tokens
        if S % bt:
            raise ValueError(f"prefill length {S} is not block-aligned")
        nblk = S // bt
        tbl = self.global_ids(self.block_tables[:, :nblk].clamp(min=0))
        tbl = tbl.long().reshape(-1)
        for src, pool in ((k, self.k_pool), (v, self.v_pool)):
            if src is None:
                continue
            blocks = src.reshape(L, B * nblk, bt, *src.shape[3:])
            pool[:, tbl] = blocks.to(pool.dtype)
        return dataclasses.replace(self, seq_lens=lengths.to(torch.int32))


class PagedKVManager:
    """Host-side allocator policy for the cache -- a thin Arena client.

    The manager used to own its own ``BlockAllocator`` and dict-of-lists
    tables; it is now a facade over ``repro_torch.mem``: one ``Mapping`` per
    live sequence drawn from a shared ``Arena`` pool class, so the KV
    cache, TreeArrays, BlockStacks and the host swap tier all account
    against ONE address space.  The manager still deals ONLY in block
    ids at its boundary -- payload transfers (swap-out/in at block
    granularity, COW block copies) are the caller's job, so that bytes
    moved always scale with blocks held, never with pool size (see
    ``serve/swap.py`` and ``kernels/block_copy.py``).
    """

    def __init__(self, config: PagedKVConfig, arena: Optional[Arena] = None,
                 pool_class: str = "kv"):
        self.config = config
        self.arena = arena if arena is not None else Arena()
        self.pool_class = self.arena.register_class(
            pool_class, num_blocks=config.num_blocks,
            block_nbytes=config.swap_nbytes_per_block(),
            dp_groups=config.dp_groups)
        self._maps: dict[int, Mapping] = {}

    # -- compat views over the Arena -----------------------------------
    @property
    def allocator(self):
        """The pool class's raw allocator (legacy/test escape hatch)."""
        return self.arena.allocator(self.pool_class)

    @property
    def tables(self) -> dict:
        """seq_id -> block-id list of every DEVICE-resident sequence."""
        return {sid: m.block_ids() for sid, m in self._maps.items()
                if m.placement == "device"}

    @property
    def swapped(self) -> dict:
        """seq_id -> blocks held at swap-out (host-tier residency)."""
        return self.arena.host_counts(self.pool_class)

    def mapping(self, seq_id: int) -> Mapping:
        return self._maps[seq_id]

    def has_seq(self, seq_id: int) -> bool:
        """Device-resident? (O(1) -- prefer over the ``tables`` view,
        which materializes every live table on each access)."""
        m = self._maps.get(seq_id)
        return m is not None and m.placement == "device"

    def block_ids(self, seq_id: int) -> List[int]:
        return self._maps[seq_id].block_ids()

    # -- admission/extension ------------------------------------------
    def blocks_needed(self, tokens: int) -> int:
        bt = self.config.block_tokens
        return (tokens + bt - 1) // bt

    @property
    def free_blocks(self) -> int:
        """Leases currently grantable -- the scheduler's admission view."""
        return self.arena.num_free(self.pool_class)

    def admit(self, seq_id: int, tokens: int,
              tenant: str = "default") -> List[int]:
        need = self.blocks_needed(tokens)
        if need > self.free_blocks:
            # atomic: don't leave an empty mapping behind on failure
            raise OutOfBlocksError(
                f"requested {need} blocks, only {self.free_blocks} free")
        m = self.arena.mapping(self.pool_class, seq_id, tenant=tenant)
        self._maps[seq_id] = m
        return m.ensure_capacity(need)

    def extend(self, seq_id: int, new_total_tokens: int) -> List[int]:
        """Ensure capacity for new_total_tokens; returns newly added ids.

        Allocates under pressure: on exhaustion the Arena's reclaimer
        (LIFO preemption when serving) evicts victims; if the victim is
        this sequence itself, ``LeaseRevokedError`` propagates.
        """
        return self._maps[seq_id].ensure_capacity(
            self.blocks_needed(new_total_tokens))

    def release(self, seq_id: int) -> None:
        self._maps.pop(seq_id).free()

    def adopt(self, seq_id: int, mapping: Mapping) -> None:
        """Register an existing Arena mapping under this manager (the
        restart path: ``Arena.restore`` rebuilds host-resident mappings
        and the engine re-adopts them so preempted sequences resume)."""
        if mapping.pool_class != self.pool_class:
            raise ValueError(
                f"adopt of mapping in pool class {mapping.pool_class!r}; "
                f"this manager allocates in {self.pool_class!r}")
        if seq_id in self._maps:
            raise ValueError(f"sequence {seq_id} already tracked")
        self._maps[seq_id] = mapping

    def disown(self, seq_id: int) -> Mapping:
        """Stop tracking ``seq_id`` WITHOUT freeing its mapping -- the
        inverse of ``adopt``.  The disaggregation handoff: a prefill
        worker disowns the finished sequence so ``export_mapping`` can
        gather its blocks into a bundle and release them."""
        return self._maps.pop(seq_id)

    def reserve_sink(self):
        """Pin one block (never handed to a sequence).

        The engine points masked prefill-table entries at this 'sink'
        block so padded rows and COW-aliased prefixes have a harmless
        scatter target.  Returns the pinned ``Lease`` -- read
        ``lease.block`` for the current physical id (compaction may
        relocate it).
        """
        return self.arena.pin(self.pool_class, owner="sink")

    def reserve_block(self) -> int:
        """Legacy form of ``reserve_sink``: the pinned id as an int."""
        return self.reserve_sink().block

    # -- COW prefix sharing ---------------------------------------------
    def fork(self, parent_id: int, child_id: int, shared_tokens: int,
             tenant: Optional[str] = None) -> List[int]:
        """COW: child aliases EVERY parent block covering shared_tokens.

        A trailing partially-filled block is aliased too; the first
        divergent write into it goes through ``ensure_writable`` which
        fulfils the copy-on-write (paper Table 1 row 'Copy-on-Write').
        Callers that only want fully-shared blocks pass shared_tokens
        rounded down to a block multiple.
        """
        bt = self.config.block_tokens
        nshared = -(-shared_tokens // bt)
        parent = self._maps[parent_id]
        if nshared > len(parent):
            raise ValueError(
                f"fork of {shared_tokens} tokens needs {nshared} blocks, "
                f"parent holds {len(parent)}")
        child = parent.fork(child_id, nshared, tenant=tenant)
        self._maps[child_id] = child
        return child.block_ids()

    def ensure_writable(self, seq_id: int,
                        token_pos: int) -> Optional[Tuple[int, int]]:
        """COW write barrier for the block covering ``token_pos``.

        If that block is shared (refcount > 1) the sequence gets a fresh
        private block in its table and the fulfilment copy is ENQUEUED
        on the Arena's transfer plane (the fresh block stays in-flight
        until the engine dispatches the queue); ``(src, dst)`` is
        returned for copy-traffic accounting, None when the block is
        already exclusively owned.  The fresh block is a deferred claim
        allocated under pressure (see ``Mapping.ensure_writable``).
        """
        return self._maps[seq_id].ensure_writable(
            token_pos // self.config.block_tokens)

    # -- swapping ---------------------------------------------------------
    def swap_out(self, seq_id: int) -> List[int]:
        """Migrate a preempted sequence to the host tier; return the
        vacated device ids.

        The payload move is a d2h plan on the Arena's transfer plane:
        the vacated ids stay held until its gather is dispatched, and
        the host copy lands at the next fence (``serve/swap.py`` keeps
        the byte ledger).
        """
        return self._maps[seq_id].migrate("host")

    def swap_in(self, seq_id: int) -> List[int]:
        """Migrate back: reallocate (anywhere!) and return the new block
        ids, with the scatter of the saved payload enqueued as an h2d
        plan.

        The new physical blocks need not match the old ones -- block
        tables absorb the relocation, which is the paper's 'Relocation /
        Migration' row implemented in software.
        """
        return self._maps[seq_id].migrate("device")

    # -- speculative swap-in (prefetch) ---------------------------------
    def prefetch(self, seq_id: int) -> List[int]:
        """Speculatively swap a preempted sequence back in on the
        BACKGROUND h2d lane: fresh blocks are allocated and the scatter
        enqueued, but host residency and payload stay intact until
        ``commit_prefetch`` -- so the speculation costs nothing to
        cancel (``Mapping.prefetch``)."""
        return self._maps[seq_id].prefetch()

    def is_prefetched(self, seq_id: int) -> bool:
        m = self._maps.get(seq_id)
        return m is not None and m.prefetched

    def prefetched_ids(self) -> List[int]:
        """Sequences with an uncommitted speculative swap-in (the
        pressure path's cheapest reclaim victims)."""
        return [sid for sid, m in self._maps.items() if m.prefetched]

    def commit_prefetch(self, seq_id: int) -> Tuple[List[int], bool]:
        """Promote the speculation to the real resume; returns
        ``(new_ids, served_from_completed_prefetch)``."""
        return self._maps[seq_id].commit_prefetch()

    def cancel_prefetch(self, seq_id: int) -> None:
        """Withdraw the speculation (candidate evicted/freed or memory
        tightened): blocks release, host state stays resumable."""
        self._maps[seq_id].cancel_prefetch()

    @property
    def speculative_blocks(self) -> int:
        """Device blocks held by uncommitted prefetches.  Admission
        counts these as FREE (they cancel instantly under pressure), so
        scheduling decisions are identical with and without
        speculation."""
        return sum(m.spec_blocks for m in self._maps.values())

    def device_table(self, seq_id: int) -> np.ndarray:
        return self._maps[seq_id].packed_table(self.config.max_blocks_per_seq)

    @property
    def utilization(self) -> float:
        return (self.arena.num_used(self.pool_class)
                / self.arena.num_blocks(self.pool_class))
