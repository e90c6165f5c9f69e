"""Host swap ledger: block-granular device<->host (paper 'Swapping').

Since the transfer-plane redesign, NOTHING here moves bytes.  Swap-out
and swap-in are ``TransferPlan``s produced by ``Mapping.migrate`` (or
``Mapping.prefetch``) and executed by the Arena's per-direction
``TransferEngine``s (``mem/transfer.py`` -- the only module allowed to
touch the block-copy kernels or the host tier's payload verbs; a
grep-enforced test pins that rule).  This module is the serving stack's
*ledger and view* over that plane, KEYED BY ENGINE:

  * ``SwapStats`` accumulates the byte ledger from completed plans (the
    store registers itself as a queue observer), split per engine/lane
    (``by_engine``): d2h swap-outs, urgent-lane h2d swap-ins, and
    background-lane speculative prefetches each have their own row, so
    prefetch traffic is never conflated with demand swap traffic.  The
    regression surface is preserved: every swap-out moves exactly

        blocks_held * config.swap_nbytes_per_block()

    bytes -- proportional to what the sequence holds and INDEPENDENT of
    pool size.  The naive alternative (materialising the whole pool on
    host and slicing there) moves ``num_blocks / blocks_held`` times
    more; tests pin this ratio out of existence, the same way the cost
    model pins pool-size-independent byte bills.
  * **speculative accounting is two-phase**: a completed prefetch
    scatter parks its bytes in ``pending_prefetch`` (moved, but not yet
    a swap-in -- the host copy is still authoritative); the engine's
    ``commit_prefetch`` folds them into ``swap_ins``/``swap_in_bytes``
    when the resume actually lands, and ``cancel_prefetch`` writes them
    off as ``prefetch_wasted_bytes``.  The demand-swap ledger is
    therefore byte-identical between the prefetching schedule and the
    ``drain()`` fallback (asserted by the engine tests), while
    the speculation's true cost stays visible.
  * ``__contains__`` / ``__len__`` are the engine-invariant views:
    residency lives in the Arena's host tier, and a sequence mid-swap
    (payload still in a dispatched-but-unfenced d2h plan) is IN
    TRANSIT, which ``Engine.check_consistency`` accounts for
    explicitly.

Because payload transfers ride the queues, swap-out device gathers
dispatch at step N and their host copies land at the step N+1 fence --
double-buffered -- while ``queue.drain()``
remains the synchronous fallback with byte-identical demand traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.mem import Arena
from repro_torch.mem.transfer import D2H, H2D, TransferPlan


def _engine_rows() -> Dict[str, Dict[str, int]]:
    return {"d2h": {"plans": 0, "bytes": 0},
            "h2d": {"plans": 0, "bytes": 0},
            "h2d-prefetch": {"plans": 0, "bytes": 0}}


@dataclasses.dataclass
class SwapStats:
    swap_outs: int = 0
    swap_ins: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    last_swap_out_bytes: int = 0
    #: per-engine/lane plan+byte ledger (d2h / h2d / h2d-prefetch)
    by_engine: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=_engine_rows)
    prefetch_commits: int = 0      # resumes folded in from speculation
    prefetch_cancels: int = 0      # executed prefetches written off
    prefetch_wasted_bytes: int = 0
    # (seq_id, blocks_moved, bytes_moved) per swap-out, completion order
    out_log: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)


class HostBlockStore:
    """Byte ledger + residency view for preempted sequences' payloads.

    Standalone construction (no arena) creates a private Arena so the
    class keeps working as a self-contained store; serving passes the
    engine's shared arena + pool class so host-tier residency, payloads
    and ``ArenaStats`` placement counts all live in ONE address space.
    The ledger updates when plans COMPLETE (at the fence), so bytes
    reported are bytes actually moved -- except speculative prefetches,
    which park in ``_pending_prefetch`` until the engine commits or
    cancels them (see module docstring).
    """

    def __init__(self, arena: Optional[Arena] = None,
                 pool_class: str = "kv"):
        self.arena = arena if arena is not None else Arena()
        self.pool_class = pool_class
        self.stats = SwapStats()
        self._pending_prefetch: Dict[object, int] = {}   # owner -> nbytes
        self.arena.transfers.add_observer(self._on_complete,
                                          key=f"swap-ledger:{pool_class}")

    def _on_complete(self, plan: TransferPlan) -> None:
        if plan.pool_class != self.pool_class:
            return
        st = self.stats
        if plan.direction == D2H and plan.kind == "swap-out":
            st.swap_outs += 1
            st.swap_out_bytes += plan.nbytes
            st.last_swap_out_bytes = plan.nbytes
            st.by_engine["d2h"]["plans"] += 1
            st.by_engine["d2h"]["bytes"] += plan.nbytes
            st.out_log.append((plan.owner, int(plan.src.size), plan.nbytes))
        elif plan.direction == H2D and plan.kind == "swap-in":
            if plan.speculative:
                # the transfer plane re-notifies the SAME plan on
                # commit/abandon (Mapping.commit_prefetch /
                # cancel_prefetch -- whoever the caller was, serving
                # engine or a direct migrate("device")), so the
                # two-phase accounting needs no engine-side glue
                if plan.committed:
                    self._commit_prefetch(plan.owner)
                elif plan.abandoned:
                    self._cancel_prefetch(plan.owner)
                else:
                    # moved, but not yet a resume: park until
                    # commit/cancel
                    st.by_engine["h2d-prefetch"]["plans"] += 1
                    st.by_engine["h2d-prefetch"]["bytes"] += plan.nbytes
                    self._pending_prefetch[plan.owner] = plan.nbytes
            else:
                st.swap_ins += 1
                st.swap_in_bytes += plan.nbytes
                st.by_engine["h2d"]["plans"] += 1
                st.by_engine["h2d"]["bytes"] += plan.nbytes

    # ---------------- speculative two-phase accounting ----------------
    def _commit_prefetch(self, seq_id) -> None:
        """A resume was served from the speculative swap-in: fold the
        parked bytes into the demand ledger.  No-op when the prefetch
        had not completed at commit (the promoted plan then completes
        as a normal swap-in and is counted by the observer)."""
        nbytes = self._pending_prefetch.pop(seq_id, None)
        if nbytes is None:
            return
        st = self.stats
        st.swap_ins += 1
        st.swap_in_bytes += nbytes
        st.prefetch_commits += 1

    def _cancel_prefetch(self, seq_id) -> None:
        """The speculation was withdrawn after its scatter ran: write
        the parked bytes off as waste (they never became a resume)."""
        nbytes = self._pending_prefetch.pop(seq_id, None)
        if nbytes is None:
            return
        self.stats.prefetch_cancels += 1
        self.stats.prefetch_wasted_bytes += nbytes

    # ---------------- residency views ----------------
    def __contains__(self, seq_id: int) -> bool:
        return self.arena.host_contains(self.pool_class, seq_id)

    def __len__(self) -> int:
        return self.arena.host_len(self.pool_class)

    def in_transit(self, seq_id: int) -> bool:
        """Swap-out enqueued/dispatched but its host copy not fenced yet."""
        return seq_id in self.arena.transfers.in_transit(self.pool_class)

    # NOTE: cancelling a sequence while preempted goes through
    # ``PagedKVManager.release`` (``Mapping.free``), which settles any
    # in-transit plan, withdraws any parked prefetch, and tears down
    # host residency AND payload together -- a store-level drop would
    # desync the views the engine's check_consistency pins.
