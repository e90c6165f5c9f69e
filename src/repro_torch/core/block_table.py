"""Block-table utilities: the compaction plan.

With fixed blocks there is NO external fragmentation (the paper's
point), so "defrag" only means migrating live blocks to a dense prefix
so a shrinking pool can return arena memory -- a pure block copy plan
plus a table rewrite (``Arena.compact``), never a data-structure
rebuild.  The reference module's deep tables arrive with the slice that
ports the paper's data structures.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


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
