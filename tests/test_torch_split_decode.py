"""The split-key decode kernels' host arithmetic, on the CPU.

``ops.plan_decode_splits`` cuts each row's table into the ranges that
the CUDA decode kernels -- the append (#1) and ``paged_attention`` (#7)
-- give one CTA each; their merge kernel combines the ranges' partial
softmax sums with the log-sum-exp rule, #7's also with the self term
(the new token of absorbed MLA decode, one more partial).  Here the plan
must cover every table entry exactly once, also at #7's MLA shapes (G
40, latent 288, V 256; G 16, latent 576, V 512) and at #1's widths of
Qwen3-30B-A3B (KVH 4, G 8, HD 128) and gemma3-27b (KVH 16, G 2, a
1024-token window), and the merge -- written below with the merge
kernel's formula -- applied to partials computed plainly over each
split's range must equal ``ref.paged_attention_append_ref`` and
``ref.paged_attention_ref`` (float32, 1e-6), empty splits and rows with
no key included, and #7's must also equal the Pallas ``paged_attention``
in interpret mode and, with the self term, the reference's ``_paged_ref``
followed by ``_merge_self`` (3e-5: sums in another order).  The kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as JA
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


def merge(m, l, acc, self_s=None, self_v=None):
    """The merge kernel's rule: over the splits with l > 0,
    O = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max m_s;
    0 where no split has a key.  m, l: (S, R); acc: (S, R, VD).  A self
    term (score self_s (R,), value self_v (R, VD)) is one more split with
    m = self_s, l = 1, acc = self_v."""
    if self_s is not None:
        m = torch.cat([m, self_s[None]])
        l = torch.cat([l, torch.ones_like(self_s)[None]])
        acc = torch.cat([acc, self_v[None]])
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, _NEG)).amax(0)
    w = torch.where(live, torch.exp(m - M), torch.zeros_like(m))
    L = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0)
    return torch.where(L[:, None] > 0, o / L.clamp(min=1e-30)[:, None],
                       torch.zeros_like(o))


def split_partials(q, k_pool, v_pool, tables, n_keys, key_lo, S, W, *,
                   scale, softcap, v_dim=None):
    """Each split's (m, l, acc) over its range [s * W, (s + 1) * W) of
    the keys [key_lo, n_keys), computed plainly; an empty split gives
    (-1e30, 0, 0).  V is the first ``v_dim`` lanes of ``v_pool``'s rows
    (default all).  Returns m, l (S, B*KVH*G) and acc (S, B*KVH*G, VD)."""
    B, KVH, G, HD = q.shape
    BT, MB = k_pool.shape[1], tables.shape[1]
    VD = v_dim or v_pool.shape[-1]
    tbl = tables.long().clamp(min=0)
    k = k_pool[tbl].reshape(B, MB * BT, KVH, HD).float()
    v = v_pool[tbl].reshape(B, MB * BT, KVH, -1)[..., :VD].float()
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


# ---------------------------------------------------------------------------
# #7 paged_attention: the plan at MiniCPM3-4B's widths, and the merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,MB,BT", list(itertools.product(
    [1, 4, 16, 64], [1, 6, 64, 1000], [16, 64])))
def test_plan_at_mla_widths_covers_every_table_entry_once(B, MB, BT):
    """#7 at G 40 (one latent kv head of 288, V 256): one CTA holds all
    40 heads, more than half an SM's shared memory, so the grid keeps to
    one CTA per SM; every key position lies in exactly one split."""
    S, W = ops.plan_decode_splits(B, 1, MB, BT, 40)
    assert (W % BT == 0 or BT % W == 0) and W >= min(ops.MIN_SPLIT_TOKENS,
                                                     BT)
    ranges = [(s * W, min((s + 1) * W, MB * BT)) for s in range(S)]
    assert all(lo < hi <= MB * BT for lo, hi in ranges)
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    assert np.array_equal(covered, np.arange(MB * BT))
    assert B * S <= ops.SM_COUNT or S == 1
    if W > min(ops.MIN_SPLIT_TOKENS, BT):
        narrower = W // 2 if W <= BT else W - BT
        assert B * -(-(MB * BT) // narrower) > ops.SM_COUNT
    assert ops.plan_decode_splits(B, 1, MB, BT, 16) == \
        ops.plan_decode_splits(B, 1, MB, BT)


def test_plan_at_minicpm3_4b_decode():
    """The recorded heaviest MLA decode call: B 4, one latent head, 6
    blocks of 64 tokens, G 40 -> half-block splits, 12 per row, 48 CTAs
    (as gemma-2b's append); at 4096 keys per row, 32 splits of 128 keys
    (128 CTAs, one wave) where G 8 takes 64 splits of 64."""
    S, W = ops.plan_decode_splits(4, 1, 6, 64, 40)
    assert (S, W) == (12, 32) and 4 * 1 * S == 48
    assert ops.plan_decode_splits(4, 1, 64, 64, 40) == (32, 128)
    assert ops.plan_decode_splits(4, 1, 64, 64) == (64, 64)


@pytest.mark.parametrize("B,KVH,MB,G,want", [
    (4, 1, 6, 16, (12, 32)),        # #7, DeepSeek-V2-Lite's decode
    (4, 1, 64, 16, (64, 64)),       # #7, DeepSeek-V2-Lite at 4096 keys
    (4, 4, 6, 8, (12, 32)),         # #1, Qwen3-30B-A3B's decode
    (4, 4, 64, 8, (16, 256)),       # #1, Qwen3-30B-A3B at 4096 keys
    (4, 16, 6, 2, (3, 128)),        # #1, gemma3-27b's decode
    (4, 16, 20, 2, (4, 320))])      # #1, gemma3-27b past its 1024 window
def test_plan_at_the_new_widths(B, KVH, MB, G, want):
    """The decode plans at the widths of this slice's models (64-token
    blocks): every key position in exactly one split, the grid within two
    CTAs per SM (G <= 16), the narrowest such width."""
    S, W = ops.plan_decode_splits(B, KVH, MB, 64, G)
    assert (S, W) == want
    assert (S - 1) * W < MB * 64 <= S * W
    assert B * KVH * S <= 2 * ops.SM_COUNT
    if W > ops.MIN_SPLIT_TOKENS:
        narrower = W // 2 if W <= 64 else W - 64
        assert B * KVH * -(-(MB * 64) // narrower) > 2 * ops.SM_COUNT


@pytest.mark.parametrize("KVH,G,MB,window", [
    (4, 8, 6, None),                # Qwen3-30B-A3B: KVH 4, G 8, HD 128
    (16, 2, 24, 1024),              # gemma3-27b local: G 2, a 1024 window
    (16, 2, 24, None)])             # gemma3-27b global
def test_append_merge_at_the_new_widths(KVH, G, MB, window):
    """#1 at head_dim 128 on 64-token blocks, 4 rows at a time (a decode
    step's batch, so the plan splits the keys): the merge of the planned
    splits' partials equals #1's plain version (1e-6), the Pallas
    ``paged_attention_append`` in interpret mode and the reference's
    ``_paged_ref`` + ``_merge_self`` (3e-5), with lengths at block edges
    and around the window's edge (the first key ``lens + 1 - window`` at
    0, 1, a block edge, a split's edge and just past it)."""
    BT, HD, B = 64, 128, 4
    rng = np.random.default_rng(KVH * 100 + MB)
    n = MB * BT
    S, W = ops.plan_decode_splits(B, KVH, MB, BT, G)
    assert S > 1
    lens = [0, 1, BT - 1, BT, BT + 1, n - 2]
    if window:
        lens += [window - 1, window, window - 1 + BT, window - 1 + W,
                 window + W]
    lens += [2] * (-len(lens) % B)
    assert max(lens) < n - 1                   # the new row fits the table
    NB = B * MB + 1
    scale = HD ** -0.5

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    for rows in range(0, len(lens), B):
        q, kn, vn = t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, HD))
        kp, vp = t((NB, BT, KVH, HD)), t((NB, BT, KVH, HD))
        tables = torch.from_numpy(rng.permutation(NB)[: B * MB]
                                  .reshape(B, MB).astype(np.int32))
        tables[:1, 1:] = -1 if rows == 0 else tables[:1, 1:]
        lens_t = torch.tensor(lens[rows:rows + B], dtype=torch.int32)
        jq, jkn, jvn, jkp, jvp, jt, jl = (jnp.asarray(x.numpy()) for x in (
            q, kn, vn, kp, vp, tables, lens_t))
        want, k_after, v_after = ref.paged_attention_append_ref(
            q, kn, vn, kp.clone(), vp.clone(), tables, lens_t, scale=scale,
            softcap=None, window=window)
        nk = torch.clamp(lens_t.long() + 1, max=n)
        lo = torch.clamp(lens_t.long() + 1 - window, min=0) if window \
            else torch.zeros(B, dtype=torch.long)
        m, l, acc = split_partials(q, k_after, v_after, tables, nk, lo, S, W,
                                   scale=scale, softcap=None)
        got = merge(m, l, acc).reshape(B, KVH, G, HD)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        po = jops.paged_attention_append(
            jq, jkn, jvn, jnp.array(jkp), jnp.array(jvp), jt, jl,
            scale=scale, softcap=None, window=window, interpret=True)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(po), rtol=3e-5,
                                   atol=3e-5)
        o_c, l_c, m_c = JA._paged_ref(
            jq, jkp, jvp, jt, jl, scale=scale, softcap=None,
            window=None if window is None else jnp.asarray(window))
        s_self = jnp.einsum("bhgd,bhd->bhg", jq * scale, jkn)
        jo = JA._merge_self(o_c, l_c, m_c, s_self, jvn[:, :, None, :])
        np.testing.assert_allclose(got.numpy(), np.asarray(jo), rtol=3e-5,
                                   atol=3e-5)


#: (KVH, G, HD, VD, latent): MLA's 40 heads over one latent head whose
#: first VD lanes are V (MiniCPM3-4B's shape at a narrower latent),
#: DeepSeek-V2-Lite's 16 heads over its 576-wide latent with V 512, and
#: GQA with a separate V pool
PA_MODES = [(1, 40, 96, 64, True), (1, 16, 576, 512, True),
            (2, 4, 64, 32, False)]


@pytest.mark.parametrize("mode", PA_MODES)
@pytest.mark.parametrize("BT,MB", [(64, 3), (16, 8)])
@pytest.mark.parametrize("softcap,edge_window", [(None, False), (30.0, False),
                                                 (None, True), (50.0, True)])
@pytest.mark.parametrize("with_self", [False, True])
def test_merge_of_paged_attention_split_partials(mode, BT, MB, softcap,
                                                 edge_window, with_self):
    """#7's partials over its planned splits, merged by the kernel's rule
    (with the self term as one more split), against its plain version at
    1e-6, and against Pallas #7 in interpret mode (no self term: the
    Pallas kernel has none; rows of length 0, where Pallas gives the mean
    of V, left out) or ``_paged_ref`` + ``_merge_self`` (self term) at
    3e-5.  Lengths sit at every split and block edge and at the full
    table, rows 0 and 1 have NULL entries past their first block, and
    the edge window (2 W) puts ``lens - window`` on a split's edge for
    the full row and inside a split for the row one shorter."""
    KVH, G, HD, VD, latent = mode
    S, W = ops.plan_decode_splits(8, KVH, MB, BT, G)
    assert S > 1
    rng = np.random.default_rng(BT * 100 + MB + G)
    n = MB * BT
    lens = [0, 1, W - 1, W, W + 1, BT + 1, n - 1, n]
    B = len(lens)
    NB = B * MB + 1
    window = 2 * W if edge_window else None
    assert n % W == 0                       # n - 2 W is a split's edge

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kp = t((B, KVH, G, HD)), t((NB, BT, KVH, HD))
    vp = kp if latent else t((NB, BT, KVH, VD))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB]
                              .reshape(B, MB).astype(np.int32))
    tables[:2, 1:] = -1
    lens_t = torch.tensor(lens, dtype=torch.int32)
    self_s = 3 * t((B, KVH, G)) if with_self else None
    self_v = t((B, KVH, VD)) if with_self else None
    scale = HD ** -0.5
    kw = dict(scale=scale, softcap=softcap, window=window,
              v_dim=VD if latent else None)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens_t, **kw,
                                   self_score=self_s, self_v=self_v)
    nk = torch.clamp(lens_t.long(), max=n)
    lo = torch.clamp(lens_t.long() - window, min=0) if window \
        else torch.zeros(B, dtype=torch.long)
    m, l, acc = split_partials(q, kp, vp, tables, nk, lo, S, W, scale=scale,
                               softcap=softcap, v_dim=VD)
    assert bool((l == 0).any())                  # some splits are empty
    got = merge(m, l, acc,
                None if self_s is None else self_s.reshape(-1),
                None if self_v is None else
                self_v[:, :, None].expand(B, KVH, G, VD).reshape(-1, VD))
    got = got.reshape(B, KVH, G, VD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jq, jk, jt, jl = (jnp.asarray(x.numpy()) for x in (q, kp, tables, lens_t))
    jv = jk if latent else jnp.asarray(vp.numpy())
    if not with_self:
        po = jops.paged_attention(jq, jk, jv, jt, jl, scale=scale,
                                  softcap=softcap, window=window,
                                  v_dim=VD if latent else None,
                                  interpret=True)
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(po)[1:],
                                   rtol=3e-5, atol=3e-5)
        assert not got[0].any()
        return
    # _paged_ref's window keeps pos >= lens - window + 1: one wider here
    o_c, l_c, m_c = JA._paged_ref(
        jq, jk, jv, jt, jl, scale=scale, softcap=softcap,
        window=None if window is None else jnp.asarray(window + 1),
        v_dim=VD if latent else None)
    jo = JA._merge_self(o_c, l_c, m_c, jnp.asarray(self_s.numpy()),
                        jnp.asarray(self_v.numpy())[:, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(jo), rtol=3e-5,
                               atol=3e-5)
