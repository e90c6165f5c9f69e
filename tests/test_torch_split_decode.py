"""The split-key decode append's host arithmetic, on the CPU.

``ops.plan_decode_splits`` cuts each row's table into the ranges that
the CUDA append kernel gives one CTA each; its merge kernel combines the
ranges' partial softmax sums with the log-sum-exp rule.  Here the plan
must cover every table entry exactly once, and the merge -- written
below with the merge kernel's formula -- applied to partials computed
plainly over each split's range must equal
``ref.paged_attention_append_ref`` (float32, 1e-6), empty splits and
rows with no key included.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

_NEG = -1e30                     # the kernels' "no score yet"


@pytest.mark.parametrize("B,KVH,MB,BT", list(itertools.product(
    [1, 4, 64], [1, 16], [1, 6, 64, 1000], [8, 64])))
def test_plan_covers_every_table_entry_once(B, KVH, MB, BT):
    S, W = ops.plan_decode_splits(B, KVH, MB, BT)
    assert S >= 1 and W >= 1 and (W % BT == 0 or BT % W == 0)
    ranges = [(s * W, min((s + 1) * W, MB * BT)) for s in range(S)]
    assert all(lo < hi <= MB * BT for lo, hi in ranges)  # none empty/past
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    # every key position, so every table entry's BT positions, exactly once
    assert np.array_equal(covered, np.arange(MB * BT))
    assert W >= min(ops.MIN_SPLIT_TOKENS, BT)
    # the narrowest width that keeps the grid within two CTAs per SM
    if W > min(ops.MIN_SPLIT_TOKENS, BT):
        narrower = W // 2 if W <= BT else W - BT
        assert B * KVH * -(-(MB * BT) // narrower) > 2 * ops.SM_COUNT


def test_plan_at_gemma_2b_decode():
    # B 4, KVH 1, MB 6, BT 64: half-block splits, 48 CTAs
    assert ops.plan_decode_splits(4, 1, 6, 64) == (12, 32)


def merge(m, l, acc):
    """The merge kernel's rule: over the splits with l > 0,
    O = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max m_s;
    0 where no split has a key.  m, l: (S, R); acc: (S, R, VD)."""
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, _NEG)).amax(0)
    w = torch.where(live, torch.exp(m - M), torch.zeros_like(m))
    L = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0)
    return torch.where(L[:, None] > 0, o / L.clamp(min=1e-30)[:, None],
                       torch.zeros_like(o))


def split_partials(q, k_pool, v_pool, tables, n_keys, key_lo, S, W, *,
                   scale, softcap):
    """Each split's (m, l, acc) over its range [s * W, (s + 1) * W) of
    the keys [key_lo, n_keys), computed plainly; an empty split gives
    (-1e30, 0, 0).  Returns m, l (S, B*KVH*G) and acc (S, B*KVH*G, VD)."""
    B, KVH, G, HD = q.shape
    BT, MB = k_pool.shape[1], tables.shape[1]
    VD = v_pool.shape[-1]
    tbl = tables.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, MB * BT, KVH, HD).float()
    v = v_pool[tbl].reshape(B, MB * BT, KVH, VD).float()
    s = torch.einsum("bhgd,bshd->bhgs", q.float() * scale, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(MB * BT)[None, :]
    ms, ls, accs = [], [], []
    for sp in range(S):
        lo, hi = sp * W, min((sp + 1) * W, MB * BT)
        valid = (pos >= torch.maximum(key_lo[:, None], torch.tensor(lo))) \
            & (pos < torch.minimum(n_keys[:, None], torch.tensor(hi)))
        vm = valid[:, None, None, :].expand_as(s)
        x = torch.where(vm, s, torch.full_like(s, _NEG))
        m = x.amax(-1)
        p = torch.where(vm, torch.exp(x - m[..., None]), torch.zeros_like(x))
        l = p.sum(-1)
        acc = torch.einsum("bhgs,bshd->bhgd", p, v)
        ms.append(torch.where(l > 0, m, torch.full_like(m, _NEG)).reshape(-1))
        ls.append(l.reshape(-1))
        accs.append(acc.reshape(-1, VD))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


@pytest.mark.parametrize("BT,MB", [(64, 6), (16, 16), (8, 40)])
@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 20), (50.0, 64)])
def test_merge_of_split_partials_equals_plain_append(BT, MB, softcap,
                                                     window):
    rng = np.random.default_rng(BT * 1000 + MB)
    KVH, G, HD, VD = 2, 4, 32, 16
    lens = [0, 1, BT - 1, BT, BT + 1, MB * BT - 1, MB * BT]
    B = len(lens)
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kn, vn = t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, VD))
    kp, vp = t((NB, BT, KVH, HD)), t((NB, BT, KVH, VD))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB]
                              .reshape(B, MB).astype(np.int32))
    tables[:2, 1:] = -1                          # NULL past the first block
    lens_t = torch.tensor(lens, dtype=torch.int32)
    scale = HD ** -0.5
    want, k_after, v_after = ref.paged_attention_append_ref(
        q, kn, vn, kp.clone(), vp.clone(), tables, lens_t, scale=scale,
        softcap=softcap, window=window)
    S, W = ops.plan_decode_splits(B, KVH, MB, BT)
    assert S > 1
    n = torch.clamp(lens_t.long() + 1, max=MB * BT)
    lo = torch.clamp(lens_t.long() + 1 - window, min=0) if window \
        else torch.zeros(B, dtype=torch.long)
    m, l, acc = split_partials(q, k_after, v_after, tables, n, lo, S, W,
                               scale=scale, softcap=softcap)
    assert bool((l == 0).any())                  # some splits are empty
    got = merge(m, l, acc).reshape(B, KVH, G, VD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_merge_gives_zero_for_a_row_with_no_key():
    """Rows of length 0 (``paged_attention_ref``'s convention, which the
    append's merge shares): every split is empty and the merge gives 0,
    as the plain version does; the other rows still match it."""
    rng = np.random.default_rng(5)
    B, KVH, G, HD, BT, MB = 3, 1, 8, 32, 16, 8
    NB = B * MB

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kp, vp = t((B, KVH, G, HD)), t((NB, BT, KVH, HD)), t((NB, BT, KVH, HD))
    tables = torch.arange(NB, dtype=torch.int32).reshape(B, MB)
    lens = torch.tensor([0, 5, MB * BT], dtype=torch.int32)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens)
    S, W = ops.plan_decode_splits(B, KVH, MB, BT)
    assert S > 1
    m, l, acc = split_partials(q, kp, vp, tables, lens.long(),
                               torch.zeros(B, dtype=torch.long), S, W,
                               scale=HD ** -0.5, softcap=None)
    got = merge(m, l, acc).reshape(B, KVH, G, HD)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
