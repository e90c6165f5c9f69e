"""Plain versions of the ported kernels against the JAX package.

Each plain PyTorch version in ``repro_torch.kernels.ref`` -- what the
wrappers in ``repro_torch.kernels.ops`` run on CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel to on the card -- is checked
against the reference's Pallas kernel run in interpret mode
(``repro.kernels.ops.*(..., interpret=True)``) and against the jnp
composition the reference's model path uses, on the shapes of
``tests/test_kernels.py``.  Inputs are drawn with seeded numpy
generators and handed to both packages.

Tolerances: float32 3e-5 (sums in another order); bfloat16 3e-2 (inputs
are identical bf16 values, both sides accumulate in float32, outputs
round once to bf16).  Pools written by the kernels must match exactly.

``tests/test_torch_cuda.py`` holds the CUDA kernels themselves against
these plain versions on a card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models.lm import write_token_paged
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32_TOL, BF16_TOL = 3e-5, 3e-2
_TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _both(arr, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr.astype(np.float32)).astype(dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _append_inputs(rng, B, KVH, G, HD, BT, MB, dtype, NB=None, lens=None,
                   tables=None):
    NB = NB or B * MB + 2
    arrs = [rng.standard_normal(s) for s in
            [(B, KVH, G, HD), (B, KVH, HD), (B, KVH, HD), (NB, BT, KVH, HD),
             (NB, BT, KVH, HD)]]
    pairs = [_both(a, dtype) for a in arrs]
    if tables is None:
        tables = rng.permutation(NB)[: B * MB].reshape(B, MB)
    if lens is None:
        lens = rng.integers(0, MB * BT, B)
    tables = np.asarray(tables, np.int32)
    lens = np.asarray(lens, np.int32)
    jx = [p[0] for p in pairs] + [jnp.asarray(tables), jnp.asarray(lens)]
    tx = [p[1] for p in pairs] + [torch.from_numpy(tables),
                                  torch.from_numpy(lens)]
    return jx, tx


@pytest.mark.parametrize("B,KVH,G,HD,BT,MB", [
    (2, 1, 8, 64, 16, 4),      # MQA
    (3, 2, 4, 128, 32, 3),     # GQA
    (1, 4, 1, 64, 8, 8),       # MHA-ish
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_append_matches_pallas_and_oracle(B, KVH, G, HD, BT, MB, dtype):
    rng = np.random.default_rng(B * 100 + G)
    jx, tx = _append_inputs(rng, B, KVH, G, HD, BT, MB, dtype)
    o, k, v = ref.paged_attention_append_ref(*tx)
    jo, jk, jv = jops.paged_attention_append_ref(*jx)
    po, pk, pv = jops.paged_attention_append(*jx, interpret=True)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(o, jo, tol)
    _close(o, po, tol)
    assert np.array_equal(_np(k), _np(jk)) and np.array_equal(_np(v), _np(jv))
    assert np.array_equal(_np(k), _np(pk)) and np.array_equal(_np(v), _np(pv))


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 40), (50.0, 24)])
def test_append_softcap_window(softcap, window):
    rng = np.random.default_rng(7)
    B, KVH, G, HD, BT, MB = 2, 2, 2, 64, 16, 5
    jx, tx = _append_inputs(rng, B, KVH, G, HD, BT, MB, np.float32,
                            NB=B * MB, lens=[61, 33],
                            tables=np.arange(B * MB).reshape(B, MB))
    o, k, _ = ref.paged_attention_append_ref(*tx, softcap=softcap,
                                             window=window)
    po, pk, _ = jops.paged_attention_append(*jx, softcap=softcap,
                                            window=window, interpret=True)
    _close(o, po, F32_TOL)
    assert np.array_equal(_np(k), _np(pk))


def test_append_edges_and_null_entries():
    """lens == 0, a full table (write dropped) and a row whose unused
    table entries are NULL (-1, clamped to block 0 and masked)."""
    rng = np.random.default_rng(8)
    B, KVH, G, HD, BT, MB = 3, 2, 2, 64, 8, 3
    NB = B * MB
    tables = rng.permutation(NB).reshape(B, MB)
    tables[2, 2] = -1
    jx, tx = _append_inputs(rng, B, KVH, G, HD, BT, MB, np.float32, NB=NB,
                            lens=[0, MB * BT, 9], tables=tables)
    k_before = tx[3].clone()
    o, k, v = ref.paged_attention_append_ref(*tx)
    po, pk, pv = jops.paged_attention_append(*jx, interpret=True)
    _close(o, po, F32_TOL)
    assert np.array_equal(_np(k), _np(pk)) and np.array_equal(_np(v), _np(pv))
    assert torch.equal(k[tables[0, 0], 0], tx[1][0])
    for j in range(MB):                       # the full row wrote nothing
        assert torch.equal(k[tables[1, j]], k_before[tables[1, j]])


@pytest.mark.parametrize("window,softcap", [(0, None), (5, None), (0, 30.0),
                                            (12, 50.0)])
def test_append_equals_model_path_composition(window, softcap):
    """The fused step equals what the reference's decode runs instead:
    ``write_token_paged`` + ``_paged_ref`` over the cached tokens +
    ``_merge_self`` with the new token (window 0 = global; a window keeps
    ``pos >= len - w + 1`` of the cached tokens)."""
    rng = np.random.default_rng(9)
    B, KVH, G, HD, BT, MB = 3, 1, 4, 32, 8, 4
    NB = B * MB + 1
    jx, tx = _append_inputs(rng, B, KVH, G, HD, BT, MB, np.float32, NB=NB,
                            lens=[0, 13, 30])
    q, kn, vn, kp, vp, tb, ln = jx
    scale = HD ** -0.5
    w = jnp.asarray(window, jnp.int32)
    o_c, l_c, m_c = JA._paged_ref(q, kp, vp, tb, ln, scale=scale,
                                  softcap=softcap, window=w)
    s_self = jnp.einsum("bhgd,bhd->bhg", q * scale, kn)
    if softcap is not None:
        s_self = softcap * jnp.tanh(s_self / softcap)
    want = JA._merge_self(o_c, l_c, m_c, s_self, vn[:, :, None, :])
    want_k = write_token_paged(kp, kn, tb, ln, BT)
    o, k, _ = ref.paged_attention_append_ref(*tx, scale=scale,
                                             softcap=softcap, window=window)
    _close(o, want, F32_TOL)
    assert np.array_equal(_np(k), _np(want_k))


def _prefill_inputs(rng, B, SQ, KVH, G, HD, BT, MB, dtype, kv_lens=None,
                    starts=None, tables=None):
    NB = B * MB + 2
    arrs = [rng.standard_normal(s) for s in
            [(B, SQ, KVH, G, HD), (NB, BT, KVH, HD), (NB, BT, KVH, HD)]]
    pairs = [_both(a, dtype) for a in arrs]
    if tables is None:
        tables = rng.permutation(NB)[: B * MB].reshape(B, MB)
    if starts is None:
        starts = rng.integers(0, MB * BT - SQ + 1, B)
    starts = np.asarray(starts, np.int32)
    if kv_lens is None:
        kv_lens = starts + SQ
    ints = [np.asarray(tables, np.int32), np.asarray(kv_lens, np.int32),
            starts]
    jx = [p[0] for p in pairs] + [jnp.asarray(a) for a in ints]
    tx = [p[1] for p in pairs] + [torch.from_numpy(a) for a in ints]
    return jx, tx


@pytest.mark.parametrize("B,SQ,KVH,G,HD,BT,MB,QC", [
    (2, 16, 1, 8, 64, 16, 4, 8),    # MQA, chunked queries
    (3, 8, 2, 4, 128, 8, 3, 8),     # GQA, single chunk
    (1, 32, 4, 1, 64, 8, 8, 4),     # MHA-ish, deep sweep
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_prefill_matches_pallas_and_oracle(B, SQ, KVH, G, HD, BT, MB, QC,
                                           dtype):
    rng = np.random.default_rng(B * 10 + SQ)
    jx, tx = _prefill_inputs(rng, B, SQ, KVH, G, HD, BT, MB, dtype)
    o = ref.paged_prefill_attention_ref(*tx)
    jo = jops.paged_prefill_attention_ref(*jx)
    po = jops.paged_prefill_attention(*jx, q_chunk=QC, interpret=True)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(o, jo, tol)
    _close(o, po, tol)


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 12), (50.0, 20)])
def test_prefill_softcap_window_and_masked_rows(softcap, window):
    """Windowed/softcapped rows, padding queries past kv_len, NULL table
    entries past the sequence, and (window 12, padding) rows whose every
    key is masked -- those give 0, as in the reference."""
    rng = np.random.default_rng(11)
    B, SQ, KVH, G, HD, BT, MB = 2, 16, 2, 2, 64, 8, 6
    tables = rng.permutation(B * MB + 2)[: B * MB].reshape(B, MB)
    tables[1, 4:] = -1
    jx, tx = _prefill_inputs(rng, B, SQ, KVH, G, HD, BT, MB, np.float32,
                             kv_lens=[40, 20], starts=[24, 8],
                             tables=tables)
    o = ref.paged_prefill_attention_ref(*tx, softcap=softcap, window=window)
    po = jops.paged_prefill_attention(*jx, softcap=softcap, window=window,
                                      q_chunk=8, interpret=True)
    _close(o, po, F32_TOL)
    # model-path composition: positions (B, SQ), traced window (0 = global)
    q, kp, vp, tb, kl, st = jx
    pos = st[:, None] + jnp.arange(SQ)[None, :]
    want = JA._paged_prefill_ref(q, kp, vp, tb, kl, pos, scale=HD ** -0.5,
                                 softcap=softcap,
                                 window=jnp.asarray(window or 0, jnp.int32))
    _close(o, want, F32_TOL)


@pytest.mark.parametrize("layers,nb,blk", [(1, 8, (4, 2, 5)), (3, 10, (8,)),
                                           (2, 6, (4, 3))])
def test_gather_scatter_copy_match_pallas(layers, nb, blk):
    from repro.kernels import block_copy as jbc
    rng = np.random.default_rng(layers * 10 + nb)
    pool_np = rng.standard_normal((layers, nb, *blk)).astype(np.float32)
    ids = rng.permutation(nb)[: nb // 2].astype(np.int32)
    got = ops.gather_blocks(torch.from_numpy(pool_np), ids)
    want = jbc.gather_blocks(jnp.asarray(pool_np), jnp.asarray(ids),
                             interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    payload = rng.standard_normal((layers, len(ids), *blk)).astype(np.float32)
    pool = torch.from_numpy(pool_np.copy())
    ops.scatter_blocks(pool, ids, torch.from_numpy(payload))
    want = jbc.scatter_blocks(jnp.asarray(pool_np), jnp.asarray(ids),
                              jnp.asarray(payload), interpret=True)
    assert np.array_equal(pool.numpy(), np.asarray(want))
    src = np.array([1, 4, 2], np.int32)
    dst = np.array([5, 0, 3], np.int32)
    pool = torch.from_numpy(pool_np.copy())
    ops.copy_pool_blocks(pool, src, dst)
    want = jbc.copy_pool_blocks(jnp.asarray(pool_np), jnp.asarray(src),
                                jnp.asarray(dst), interpret=True)
    assert np.array_equal(pool.numpy(), np.asarray(want))
    flat = torch.from_numpy(pool_np[0].copy())
    ops.block_copy(flat, src, dst)
    want = jbc.block_copy(jnp.asarray(pool_np[0]), jnp.asarray(src),
                          jnp.asarray(dst), interpret=True)
    assert np.array_equal(flat.numpy(), np.asarray(want))


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    pool = torch.zeros(2, 4, 3)
    ops.copy_pool_blocks(pool, [0], [1])
    ops.gather_blocks(pool, [2])
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("bad", ["overlap", "dup_scatter", "range",
                                 "device"])
def test_block_wrappers_reject_bad_plans(bad):
    """Disjoint copy plans, distinct scatter ids and in-range ids are
    checked before any launch; inputs on a mix of devices (a meta pool
    and a CPU payload) are refused rather than sent anywhere."""
    pool = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        if bad == "overlap":
            ops.copy_pool_blocks(pool, [0, 1], [1, 2])
        elif bad == "dup_scatter":
            ops.scatter_blocks(pool, [1, 1], torch.zeros(2, 2, 3))
        elif bad == "range":
            ops.gather_blocks(pool, [4])
        else:
            ops.scatter_blocks(torch.zeros(2, 4, 3, device="meta"), [0],
                               torch.zeros(2, 1, 3))
