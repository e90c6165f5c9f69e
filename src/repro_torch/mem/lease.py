"""Typed block handles: the unit clients hold instead of raw ``int`` ids.

A ``Lease`` names exactly one block of one Arena pool class.  It is a
*mutable* handle: compaction may relocate the underlying physical block,
in which case the Arena rewrites ``lease.block`` in place -- holders
never see stale ids, which is the whole point of routing every client
through one address space (paper Table 1 row 'Relocation / Migration').

Kinds (derived, not stored -- a lease's kind changes as refcounts move):

  * ``exclusive``  -- this lease is the block's only holder (refcount 1);
    writes are safe.
  * ``cow-shared`` -- other leases alias the same block (refcount > 1);
    a write requires ``Mapping.ensure_writable`` first.
  * ``pinned``     -- permanently claimed, never handed to a sequence
    (the serving engine's write-sink block); released only via
    ``Arena.unpin``.
  * ``in-flight``  -- an unfenced transfer plan targets this block (COW
    copy destination, compaction destination, swap-in scatter target):
    the payload is not there yet.  Reads must fence first --
    ``Mapping.assert_settled`` raises ``UnfencedReadError`` otherwise.
    Set/cleared by ``mem/transfer.py``, never by clients.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.mem.arena import Arena

EXCLUSIVE = "exclusive"
COW_SHARED = "cow-shared"
PINNED = "pinned"
IN_FLIGHT = "in-flight"


class Lease:
    """One holder's claim on one block of one pool class."""

    __slots__ = ("arena", "pool_class", "block", "owner", "pinned", "live",
                 "in_flight")

    def __init__(self, arena: "Arena", pool_class: str, block: int,
                 owner, pinned: bool = False):
        self.arena = arena
        self.pool_class = pool_class
        self.block = int(block)
        self.owner = owner
        self.pinned = pinned
        self.live = True
        self.in_flight = False

    # -- queries ---------------------------------------------------------
    @property
    def refcount(self) -> int:
        return self.arena.refcount(self.pool_class, self.block)

    @property
    def shared(self) -> bool:
        return self.refcount > 1

    @property
    def kind(self) -> str:
        if self.pinned:
            return PINNED
        if self.in_flight:
            return IN_FLIGHT
        return COW_SHARED if self.shared else EXCLUSIVE

    # -- verbs (delegate to the arena so bookkeeping stays centralized) --
    def share(self, owner) -> "Lease":
        """Alias this block under a new lease (COW: refcount++)."""
        return self.arena.share(self, owner)

    def release(self) -> None:
        self.arena.release(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Lease({self.pool_class}[{self.block}] owner={self.owner} "
                f"kind={self.kind if self.live else 'dead'})")
