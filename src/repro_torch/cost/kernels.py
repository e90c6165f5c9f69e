"""One bill per port kernel launch: bytes moved and FLOPs from shapes.

The dispatcher cannot see a ctypes launch, so each wrapper of
``kernels/ops.py`` hands the bill of its launch, on the card and on meta
tensors, to the active recorder (``accounting.bill_kernel``).  The same
formulas give the bounds of ``chip_smoke.py``'s kernel rows, so a row's
bound and the account read one formula.

Bytes are each input read once and each output written once; FLOPs are
the products' ``2 M N K`` (elementwise work adds none, as in the
account), except #9's sum and the AdamW update, whose operations are all
elementwise and which are counted as their rows' bounds count them.

**Capacity.**  The paged attention kernels (#1, #2, #7, and the
split-latent pair) read as many
keys as the rows' lengths say, and a meta tensor has no lengths: so the
account bills each row at its table's capacity, ``MB * BT`` keys (#2:
every query over every key), the capacity the reference's account bills
for ``_paged_ref``'s gather.  ``chip_smoke.py`` passes the valid key
count of a recorded call (``keys=``, ``kv_keys=``, ``pairs=``) for its
rows' bounds.

Each bill splits its bytes over the account's categories: the attention
kernels read keys through the block table (``gather``) and #1 writes the
new token's K/V into the pool in place (``dynamic-update-slice``, the
reference's token write); #3 and #6 are block copies (``copy``), #4 a
gather, #5 a scatter; the tree kernels read leaves through the leaf
table (``gather``); AdamW is elementwise (``other``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

#: float32 operations per parameter of one AdamW update
ADAMW_FLOPS = 17
_I32 = 4


@dataclasses.dataclass(frozen=True)
class Bill:
    """One launch: bytes by category (``parts``) and FLOPs."""
    parts: Dict[str, float]
    flops: float

    @property
    def bytes(self) -> float:
        return float(sum(self.parts.values()))


def paged_attention_append(B, KVH, G, HD, VD, MB, BT, es,
                           keys: Optional[int] = None) -> Bill:
    """#1: q (B, KVH, G, HD), the new K/V rows read and written into the
    pool, ``keys`` cached K/V rows (all rows and kv heads; capacity
    ``B * KVH * MB * BT``), the table and lengths, the output."""
    if keys is None:
        keys = B * KVH * MB * BT
    new = (B * KVH * HD + B * KVH * VD) * es
    rest = (B * KVH * G * HD + B * KVH * G * VD) * es + new \
        + keys * (HD + VD) * es + (B * MB + B) * _I32
    return Bill({"gather": float(rest), "dynamic-update-slice": float(new)},
                float(2 * keys * G * (HD + VD)))


def paged_prefill_attention(B, SQ, KVH, G, HD, VD, MB, BT, es,
                            kv_keys: Optional[int] = None,
                            pairs: Optional[int] = None) -> Bill:
    """#2: q and the output (B, SQ, KVH, G, HD / VD), ``kv_keys`` cached
    positions read (summed over rows; capacity ``B * MB * BT``) on each
    kv head, ``pairs`` (query, key) pairs scored (summed over rows and
    queries; capacity ``B * SQ * MB * BT``), the table, lengths and
    starts."""
    if kv_keys is None:
        kv_keys = B * MB * BT
    if pairs is None:
        pairs = B * SQ * MB * BT
    nbytes = B * SQ * KVH * G * (HD + VD) * es \
        + kv_keys * KVH * (HD + VD) * es + (B * MB + 2 * B) * _I32
    return Bill({"gather": float(nbytes)},
                float(2 * pairs * KVH * G * (HD + VD)))


def paged_attention(B, KVH, G, HD, VD, MB, BT, es, out_es, *,
                    shared_kv: bool, self_term: bool,
                    keys: Optional[int] = None) -> Bill:
    """#7: q, the output (``out_es`` a lane), ``keys`` cached rows (all
    rows and kv heads; capacity ``B * KVH * MB * BT``) -- in the MLA
    latent mode (``shared_kv``) V is the first ``VD`` lanes of the same
    rows, read once -- the table and lengths, and the self term's float32
    score and value when given."""
    if keys is None:
        keys = B * KVH * MB * BT
    row = HD if shared_kv else HD + VD
    nbytes = B * KVH * G * HD * es + B * KVH * G * VD * out_es \
        + keys * row * es + (B * MB + B) * _I32
    flops = 2 * keys * G * (HD + VD)
    if self_term:
        nbytes += (B * KVH * G + B * KVH * VD) * 4
        flops += 2 * B * KVH * G * VD
    return Bill({"gather": float(nbytes)}, float(flops))


def paged_latent_scores(B, H, Lp, R, MB, BT, es,
                        keys: Optional[int] = None) -> Bill:
    """Split-latent pass 1: the float32 queries (q_lat, and q_r where
    ``R``), ``keys`` cached rows of the lora piece and rope stream (all
    rows; capacity ``B * MB * BT``), the float32 self rows, the table
    and lengths, the (B, H, MB * BT + 1) float32 scores written whole."""
    if keys is None:
        keys = B * MB * BT
    nbytes = (B * H * (Lp + R) + B * (Lp + R)) * 4 + keys * (Lp + R) * es \
        + (B * MB + B) * _I32 + B * H * (MB * BT + 1) * 4
    return Bill({"gather": float(nbytes)},
                float(2 * (keys + B) * H * (Lp + R)))


def paged_latent_values(B, H, Lp, MB, BT, es,
                        keys: Optional[int] = None) -> Bill:
    """Split-latent pass 2: the summed scores of ``keys`` cached
    positions and the self column (float32, all heads), those keys' rows
    of the lora piece, the float32 self row, the table and lengths, the
    (B, H, Lp) float32 output."""
    if keys is None:
        keys = B * MB * BT
    nbytes = (keys + B) * H * 4 + keys * Lp * es + B * Lp * 4 \
        + (B * MB + B) * _I32 + B * H * Lp * 4
    return Bill({"gather": float(nbytes)}, float(2 * (keys + B) * H * Lp))


def block_move(kind: str, n: int, L: int, blk_bytes: int) -> Bill:
    """#3-#6: ``n`` blocks of ``blk_bytes`` on ``L`` layers, each read
    once and written once; ``kind`` is the category (``copy`` for #3 and
    #6, ``gather`` for #4, ``scatter`` for #5)."""
    return Bill({kind: float(2 * n * L * blk_bytes)}, 0.0)


def tree_gather(n: int, leaf: int, es: int) -> Bill:
    """#8: ``n`` leaves read through the table and written in order."""
    return Bill({"gather": float(2 * n * leaf * es + n * _I32)}, 0.0)


def tree_block_sum(n: int, leaf: int, es: int) -> Bill:
    """#9: ``n`` leaves read, one float32 sum each written; ``n * leaf``
    additions."""
    return Bill({"gather": float(n * leaf * es + 2 * n * _I32)},
                float(n * leaf))


def tree_gather_rows(n: int, W: int, es: int) -> Bill:
    """#10: ``n`` rows of ``W`` read through the leaf table and written;
    the row ids and the table entries they reach."""
    return Bill({"gather": float(2 * n * W * es + 2 * n * _I32)}, 0.0)


def adamw_update(numel: int, p_es: int, g_es: int) -> Bill:
    """The AdamW update of one leaf: ``p`` read and written, ``g`` read,
    both float32 moments read and written (16 B a parameter);
    ``ADAMW_FLOPS`` float32 operations a parameter."""
    return Bill({"other": float((2 * p_es + g_es + 16) * numel)},
                float(ADAMW_FLOPS * numel))
