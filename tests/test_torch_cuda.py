"""The CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: each test needs a GPU that runs ``sm_90a`` code and
``nvcc`` to build the kernels, and skips elsewhere (the kernels have no
CPU mode; their plain versions are held against the JAX package in
``tests/test_torch_kernels.py``).  This file imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4, bfloat16 2e-2 (outputs round once to bf16);
pools and block copies must match exactly.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc: the CUDA "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    rng = np.random.default_rng(12)
    B, KVH, G, HD, BT, MB = 3, 1, 8, 256, 64, 4
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    q, kn, vn = t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, HD))
    kp, vp = t((NB, BT, KVH, HD)), t((NB, BT, KVH, HD))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB].reshape(B, MB)
                              .astype(np.int32)).to(cuda_device)
    lens = torch.tensor([0, 70, MB * BT], dtype=torch.int32,
                        device=cuda_device)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ro, rk, rv = ref.paged_attention_append_ref(q, kn, vn, kp.clone(),
                                                vp.clone(), tables, lens)
    o, k, v = ops.paged_attention_append(q, kn, vn, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    assert torch.equal(k, rk) and torch.equal(v, rv)
    SQ = 20
    qs = t((B, SQ, KVH, G, HD))
    kl = torch.tensor([30, 90, 256], dtype=torch.int32, device=cuda_device)
    st = torch.tensor([10, 70, 200], dtype=torch.int32, device=cuda_device)
    ro = ref.paged_prefill_attention_ref(qs, kp, vp, tables, kl, st,
                                         window=48, softcap=30.0)
    o = ops.paged_prefill_attention(qs, kp, vp, tables, kl, st, window=48,
                                    softcap=30.0)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    pool = t((2, NB, BT, KVH, HD))
    ids = np.array([3, 0, 7], np.int32)
    assert torch.equal(ops.gather_blocks(pool, ids),
                       ref.gather_blocks_ref(pool, torch.from_numpy(ids)))


#: (KVH, G, HD, MB, softcap): gemma-2b's widths at its decode table
#: (6 blocks) and at a long one (64 blocks: 4096 keys, many splits, some
#: of them empty), gemma2-27b's (16 kv heads, G 2, head_dim 128),
#: InternVL2-1B's (2 kv heads, an odd G 7, head_dim 64) and Whisper-tiny's
#: (6 kv heads, G 1, head_dim 64, its 448-token context)
SPLIT_SHAPES = [(1, 8, 256, 6, None), (1, 8, 256, 64, None),
                (16, 2, 128, 64, 50.0), (2, 7, 64, 8, None),
                (6, 1, 64, 7, None)]


def _split_inputs(dev, dtype, KVH, G, HD, MB, seed, BT=64):
    """Pools, q and tables for rows whose lengths sit at every edge of a
    block and of the table: 0, 1, BT - 1, BT, BT + 1, MB * BT - 1 and
    MB * BT (a full table drops the write); rows 0 and 1 have NULL
    entries past their first block."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, BT - 1, BT, BT + 1, MB * BT - 1, MB * BT]
    B = len(lens)
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    tables[:2, 1:] = -1
    return (t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, HD)),
            t((NB, BT, KVH, HD)), t((NB, BT, KVH, HD)),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("window", [None, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_append_matches_plain_version(cuda_device, dtype, window,
                                                 shape):
    """The split-key ``paged_attention_append`` against its plain version
    at every length edge, with NULL entries and softcap; window 100
    starts inside a block, window 128 (two blocks) on a block's edge for
    the row of length MB * BT - 1 -- a split's edge too where a split
    takes one block (gemma-2b's shapes).  Pools must be bitwise equal."""
    KVH, G, HD, MB, softcap = shape
    q, kn, vn, kp, vp, tables, lens = _split_inputs(cuda_device, dtype, KVH,
                                                    G, HD, MB, 16)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ro, rk, rv = ref.paged_attention_append_ref(
        q, kn, vn, kp.clone(), vp.clone(), tables, lens, softcap=softcap,
        window=window)
    before = ops.launch_counts()["paged_attention_append"]
    o, k, v = ops.paged_attention_append(q, kn, vn, kp, vp, tables, lens,
                                         softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention_append"] == before + 1
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    assert torch.equal(k, rk) and torch.equal(v, rv)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 256, 6, None),
                                   (16, 2, 128, 8, 50.0),
                                   (2, 7, 64, 8, None)])
@pytest.mark.parametrize("window", [None, 48, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_prefill_matches_plain_version(cuda_device, dtype, window,
                                                  shape):
    """The tensor-core ``paged_prefill_attention`` against its plain
    version: 37 queries (no whole number of 16-row tiles at G 8 or 2;
    at InternVL2's G 7 tiles straddle query positions),
    ``q_starts`` > 0, rows past ``kv_len``, and (with a window) rows
    whose every key is masked; window 64 starts on a block edge."""
    KVH, G, HD, MB, softcap = shape
    BT, SQ = 64, 37
    rng = np.random.default_rng(17)
    B = 4
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    q, kp, vp = t((B, SQ, KVH, G, HD)), t((NB, BT, KVH, HD)), \
        t((NB, BT, KVH, HD))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB].reshape(B, MB)
                              .astype(np.int32)).to(cuda_device)
    tables[0, 1:] = -1
    # (kv_len, q_start): a first prefill, a suffix at the end of a full
    # prefix, queries past kv_len, and queries far past it
    kl = torch.tensor([37, MB * BT, 200, 64], dtype=torch.int32,
                      device=cuda_device)
    st = torch.tensor([0, MB * BT - SQ, 190, 150], dtype=torch.int32,
                      device=cuda_device)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ro = ref.paged_prefill_attention_ref(q, kp, vp, tables, kl, st,
                                         softcap=softcap, window=window)
    o = ops.paged_prefill_attention(q, kp, vp, tables, kl, st,
                                    softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    if window is not None:                 # row 3's last queries: no key
        assert not o[3, -1].float().any() and not ro[3, -1].float().any()


#: (KVH, G, HD, VD, latent) of ``paged_attention``'s split cases: one
#: query head per kv head, GQA with a separate V pool, MiniCPM3-4B's 40
#: heads over one 288-wide latent head whose first 256 lanes are V
PA_SHAPES = [(4, 1, 128, 128, False), (2, 4, 64, 32, False),
             (1, 40, 288, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain_version(cuda_device, dtype):
    """``paged_attention`` in MLA latent mode at MiniCPM3-4B's widths (40
    query heads over one 288-wide latent head, V = its first 256 lanes,
    64-token blocks), with a zero-length row and NULL entries, in q's
    dtype and in float32, and in GQA mode with softcap and a window."""
    rng = np.random.default_rng(13)
    B, G, LAT, VD, BT, MB = 4, 40, 288, 256, 64, 6
    NB = B * MB + 1

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    q, pool = t((B, 1, G, LAT)), t((NB, BT, 1, LAT))
    tables = torch.from_numpy(rng.permutation(NB)[: B * MB].reshape(B, MB)
                              .astype(np.int32)).to(cuda_device)
    tables[3, 2:] = -1
    lens = torch.tensor([0, 1, MB * BT, 100], dtype=torch.int32,
                        device=cuda_device)
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, v_dim=VD)
    o = ops.paged_attention(q, pool, pool, tables, lens, v_dim=VD)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    assert not o[0].float().any()
    # float32 output (absorbed MLA un-absorbs from it): no output rounding
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, v_dim=VD,
                                 out_dtype=torch.float32)
    o = ops.paged_attention(q, pool, pool, tables, lens, v_dim=VD,
                            out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert torch.allclose(o, ro, atol=1e-4, rtol=1e-4)
    qg, kp, vp = t((B, 2, 4, 64)), t((NB, BT, 2, 64)), t((NB, BT, 2, 32))
    ro = ref.paged_attention_ref(qg, kp, vp, tables, lens, softcap=30.0,
                                 window=40)
    o = ops.paged_attention(qg, kp, vp, tables, lens, softcap=30.0,
                            window=40)
    torch.cuda.synchronize()
    assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
    # the split kernel: 6- and 64-block tables (at 64 blocks a split
    # spans several, double-buffered), lengths at every block and split
    # edge, G 1, 4 and 40, windows inside a split and on its edge, the
    # self term, float32 output
    n_cases = 0
    for (KVH, G, HD, VD, latent), MB, window, with_self in itertools.product(
            PA_SHAPES, (6, 64), (None, "edge", 100), (False, True)):
        Bn = 11
        S, W = ops.plan_decode_splits(Bn, KVH, MB, BT, G)
        assert S > 1
        lens_l = [0, 1, BT - 1, BT, BT + 1, MB * BT - 1, MB * BT,
                  W - 1, W, W + 1, 2 * W + 1]
        # the edge window starts the row of length 2 W + 1 at key W
        w = W + 1 if window == "edge" else window
        NBn = Bn * MB + 1
        q, kp = t((Bn, KVH, G, HD)), t((NBn, BT, KVH, HD))
        vp = kp if latent else t((NBn, BT, KVH, VD))
        tbl = torch.from_numpy(rng.permutation(NBn)[: Bn * MB].reshape(
            Bn, MB).astype(np.int32)).to(cuda_device)
        tbl[:2, 1:] = -1
        lens_n = torch.tensor(lens_l, dtype=torch.int32, device=cuda_device)
        kw = dict(window=w, v_dim=VD if latent else None,
                  softcap=None if latent else 30.0)
        if with_self:
            kw.update(self_score=8 * torch.randn(Bn, KVH, G,
                                                 device=cuda_device),
                      self_v=torch.randn(Bn, KVH, VD, device=cuda_device))
        for out_dtype in (dtype, torch.float32):
            ro = ref.paged_attention_ref(q, kp, vp, tbl, lens_n,
                                         out_dtype=out_dtype, **kw)
            before = ops.launch_counts()["paged_attention"]
            o = ops.paged_attention(q, kp, vp, tbl, lens_n,
                                    out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            assert ops.launch_counts()["paged_attention"] == before + 1
            t_o = tol if out_dtype == dtype else 1e-4
            assert o.dtype == out_dtype
            assert torch.allclose(o.float(), ro.float(), atol=t_o,
                                  rtol=t_o), (KVH, G, MB, window, with_self)
            if not with_self:
                assert not o[0].float().any()
            n_cases += 1
    assert n_cases == 2 * len(PA_SHAPES) * 2 * 3 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tree_kernels_match_plain_versions(cuda_device, dtype):
    """``tree_gather`` and ``tree_gather_rows`` equal their plain versions
    exactly and ``tree_block_sum`` within 1e-5 of each leaf's sum|x|, on
    16-byte-multiple leaves and on 7-element leaves of a pool whose base
    is not 16-byte aligned, with repeated ids; an empty table launches
    nothing."""
    rng = np.random.default_rng(14)
    for nb, leaf, base in ((16, 256, 0), (5, 7, 1), (3, 8192, 1)):
        flat = torch.from_numpy(rng.standard_normal(nb * leaf + 1).astype(
            np.float32)).to(cuda_device, dtype)
        leaves = flat[base:base + nb * leaf].view(nb, leaf)
        for ids in (rng.permutation(nb), [nb - 1, 0, 0, nb - 1]):
            table = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
            assert torch.equal(ops.tree_gather(leaves, table),
                               ref.tree_gather_ref(leaves, table))
            got = ops.tree_block_sum(leaves, table)
            want = ref.tree_block_sum_ref(leaves, table)
            mag = ref.tree_gather_ref(leaves, table).float().abs().sum(1)
            assert bool(((got - want).abs() <= 1e-5 * mag).all())
    for rpb, width in ((1, 64), (8, 2048), (16, 7)):
        pool = torch.from_numpy(rng.standard_normal((6, rpb, width)).astype(
            np.float32)).to(cuda_device, dtype)
        ltab = torch.from_numpy(rng.permutation(6).astype(np.int32)).to(
            cuda_device)
        rows = np.concatenate([rng.integers(0, 6 * rpb, 9),
                               [0, rpb - 1, 6 * rpb - 1, 0]])
        rows = torch.from_numpy(rows).to(cuda_device)
        assert torch.equal(ops.tree_gather_rows(pool, rows, ltab, rpb),
                           ref.tree_gather_rows_ref(pool, rows, ltab, rpb))
    before = ops.launch_counts()
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert ops.tree_gather(leaves, empty).shape == (0, leaf)
    assert ops.tree_block_sum(leaves, empty).shape == (0,)
    assert ops.launch_counts() == before
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tree_array_goes_through_the_kernels(cuda_device):
    """A TreeArray on the card: ``to_dense`` equal to the array through
    one ``tree_gather`` launch, ``scan_sum_iter`` (partial last leaf)
    within 1e-5 of sum|x| of the float64 sum through ``tree_block_sum``."""
    from repro_torch.core.treearray import TreeArray

    x = np.random.default_rng(15).standard_normal(3 * 8192 + 77).astype(
        np.float32)
    t = TreeArray.from_dense(x, leaf_size=8192, fanout=2, shuffle_seed=3,
                             device=cuda_device)
    ops.reset_launch_counts()
    assert np.array_equal(t.to_dense().cpu().numpy(), x)
    s = float(t.scan_sum_iter())
    counts = ops.launch_counts()
    assert counts["tree_gather"] == 1 and counts["tree_block_sum"] == 1
    assert abs(s - x.astype(np.float64).sum()) <= 1e-5 * np.abs(x).sum()


#: (layers, block shape, dtype, gathered ids, copied pairs, element offset
#: of the pool's base): ids at the parameter block's cap - 1, cap and
#: cap + 1 (a copy of 481 pairs carries 962 ids), 42- and 84-byte blocks
#: (not a multiple of 16), 320-byte ones (below a chunk), one layer and
#: 62 layers of gemma-2b's 32 KB and MiniCPM3-4B's 36,864-byte blocks,
#: and pool views whose base is not 16-byte aligned
BLOCK_CASES = [
    (2, (3, 7), torch.float32, ops.MAX_PARAM_IDS - 1, 479, 0),
    (2, (3, 7), torch.float32, ops.MAX_PARAM_IDS, 480, 0),
    (2, (3, 7), torch.float32, ops.MAX_PARAM_IDS + 1, 481, 0),
    (3, (3, 7), torch.bfloat16, 3, 3, 0),
    (3, (5, 2, 8), torch.float32, 3, 2, 0),
    (1, (64, 1, 256), torch.bfloat16, 2, 2, 0),
    (62, (64, 288), torch.bfloat16, 2, 2, 0),
    (3, (64, 1, 256), torch.bfloat16, 4, 2, 1),
    (4, (5, 2, 8), torch.float32, 3, 2, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_cuda_block_moves_match_plain_versions(cuda_device, case):
    """All four block wrappers with numpy ids equal their plain versions
    bitwise, one launch each."""
    L, blk, dtype, ng, nc, offset = case
    rng = np.random.default_rng(16)
    NB = max(ng, 2 * nc) + 1
    numel = L * NB * int(np.prod(blk))
    base = torch.from_numpy(rng.standard_normal(numel + 1).astype(
        np.float32)).to(cuda_device, dtype)
    pool = base[offset:offset + numel].view(L, NB, *blk)
    assert (pool.data_ptr() % 16 != 0) == (offset != 0)
    perm = rng.permutation(NB)
    gi, src, dst = perm[:ng], perm[:nc], perm[nc:2 * nc]
    ops.reset_launch_counts()
    want = ref.copy_pool_blocks_ref(pool.clone(), torch.from_numpy(src),
                                    torch.from_numpy(dst))
    assert torch.equal(ops.copy_pool_blocks(pool, src, dst), want)
    assert torch.equal(ops.gather_blocks(pool, gi),
                       ref.gather_blocks_ref(pool, torch.from_numpy(gi)))
    payload = torch.from_numpy(rng.standard_normal((L, ng, *blk)).astype(
        np.float32)).to(cuda_device, dtype)
    want = ref.scatter_blocks_ref(pool.clone(), torch.from_numpy(gi),
                                  payload)
    assert torch.equal(ops.scatter_blocks(pool, gi, payload), want)
    flat = pool[L - 1]
    want = ref.block_copy_ref(flat.clone(), torch.from_numpy(dst),
                              torch.from_numpy(src))
    assert torch.equal(ops.block_copy(flat, dst, src), want)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[k] for k in ("copy_pool_blocks", "gather_blocks",
                                "scatter_blocks", "block_copy")] == [1] * 4


def _tail_engines(cuda_device, arch):
    """Two engines on reduced float32 ``arch`` with the same weights and
    requests, one replaying captured decode graphs and one running the
    same tail eagerly.  Four requests fill the 4 slots (update width 4),
    one finishes after its second token (width 1), then the steady state
    (width 0)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(seed=3, device=cuda_device)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (9, 14, 5, 11)]
    engines = []
    for graphs in (True, False):
        eng = Engine(model, params, slots=4, max_seq=64, num_blocks=40,
                     eos_id=-1, watermark=0, prefill_budget=None,
                     graphs=graphs, device=cuda_device)
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr.copy(),
                               max_new=2 if rid == 1 else 12))
        engines.append(eng)
    return engines


def _rebind_pools(strategy):
    """Hand every pool back to the strategy as a copy at a new address,
    through the transfer-plane executors."""
    if hasattr(strategy, "cache"):
        strategy._set_streams([p.clone() for p in strategy._streams()])
    mgr = getattr(strategy, "state_mgr", None) or (
        None if hasattr(strategy, "cache") else strategy.mgr)
    if mgr is not None:
        mgr._set_streams([mgr.pool.clone()])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m", "zamba2_2p7b"])
def test_cuda_replayed_tail_matches_eager_tail(cuda_device, arch):
    """8 decode steps crossing update widths 4 -> 1 -> 0: the replayed
    graphs give the eager tail's next tokens at every step, each width is
    captured once, and every step's kernel launch counts (a replay adds
    its capture's) equal the eager step's."""
    engines = _tail_engines(cuda_device, arch)
    seen = [[], []]
    for _ in range(8):
        for i, eng in enumerate(engines):
            ops.reset_launch_counts()
            eng.step()
            torch.cuda.synchronize()
            seen[i].append((eng._next_tok.copy(), ops.launch_counts()))
    for (tg, cg), (te, ce) in zip(*seen):
        assert np.array_equal(tg, te)
        assert cg == ce
    assert sum(c["paged_attention_append"] for _, c in seen[0]) > 0 or \
        arch == "mamba2_370m"
    st = engines[0].stats["decode_graphs"]
    assert st["graphs"] and st["recaptures"] == 0
    assert {0, 1, 4} <= set(st["captures"])
    assert all(n == 1 for n in st["captures"].values())
    assert not engines[1].stats["decode_graphs"]["graphs"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m", "zamba2_2p7b"])
def test_cuda_tail_recaptures_after_pools_move(cuda_device, arch):
    """Pools rebound to new tensors through ``_set_streams`` after 4
    steps: the next replay finds a captured address changed, drops the
    graphs and captures again, and the tokens stay the eager tail's."""
    engines = _tail_engines(cuda_device, arch)
    for step in range(8):
        if step == 4:
            for eng in engines:
                _rebind_pools(eng.strategy)
        for eng in engines:
            eng.step()
        torch.cuda.synchronize()
        assert np.array_equal(engines[0]._next_tok, engines[1]._next_tok)
    assert engines[0].stats["decode_graphs"]["recaptures"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m"])
def test_cuda_capture_beside_a_swap_in_survives_collection(cuda_device,
                                                          arch):
    """A preemption after the first step, so that the resume's swap-in (a
    pinned payload copied on the default stream) and the first capture
    of width 1 fall in one step, with Python's cycle collector run at
    every allocation: the captures hold and the tokens stay the eager
    tail's."""
    import gc

    engines = _tail_engines(cuda_device, arch)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for step in range(8):
            if step == 1:
                for eng in engines:
                    eng.preempt_latest()
            for eng in engines:
                eng.step()
            torch.cuda.synchronize()
            assert np.array_equal(engines[0]._next_tok, engines[1]._next_tok)
    finally:
        gc.set_threshold(*thresholds)
    assert engines[0].preemptions == 1
    assert engines[0].stats["decode_graphs"]["recaptures"] == 0


def _prefill_strategies(dev, arch):
    """Two strategies on reduced float32 ``arch`` with the same weights
    and the same poisoned pools: the first replays its prefill buckets
    from captured graphs, the second runs them eagerly."""
    from repro_torch.configs.base import get_config
    from repro_torch.mem import Arena
    from repro_torch.models.api import build_model
    from repro_torch.serve.arch import build_strategy

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(seed=3, device=dev)
    strats = []
    for graphs in (True, False):
        s = build_strategy(model, arena=Arena(), slots=4, max_seq=64,
                           num_blocks=40, device=dev)
        s.graphs = graphs
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        for p in s._pools():
            p.copy_(torch.randn(p.shape, generator=g, device=dev,
                                dtype=p.dtype))
        strats.append(s)
    return cfg, params, strats


def _prefill_round(strats, params, cfg, rng, rid):
    """On each strategy: a (2, 2 blocks) prefill of two fresh prompts
    and, where the family has one, a (1, 1 block) suffix prefill of a
    child forked from the first prompt at its 2 blocks; then every
    sequence is released.  Returns per strategy each call's (argmax,
    logits, launch counts)."""
    from repro_torch.serve.scheduler import Request

    bt = strats[0].block_tokens
    a = Request(rid=rid, prompt=rng.integers(2, cfg.vocab_size, 2 * bt),
                max_new=1)
    b = Request(rid=rid + 1, max_new=1,
                prompt=rng.integers(2, cfg.vocab_size, bt + 3))
    child = Request(rid=rid + 2, max_new=1, prompt=np.concatenate(
        [a.prompt, rng.integers(2, cfg.vocab_size, 5)]))
    outs = []
    for s in strats:
        got = []
        for r in (a, b):
            s.admit(r.rid, len(r.prompt), "default")
        ops.reset_launch_counts()
        nxt, _ = s.prefill(params, [(0, a, 0), (1, b, 0)])
        torch.cuda.synchronize()
        got.append((nxt, s._prefill_graphs.last.clone(),
                    ops.launch_counts()))
        if s.supports_suffix_prefill:
            s.fork(a.rid, child.rid, 2 * bt, "default")
            s.extend(child.rid, len(child.prompt))
            ops.reset_launch_counts()
            nxt, _, _ = s.prefill_suffix(params, [(2, child, 2 * bt)])
            torch.cuda.synchronize()
            got.append((nxt, s._prefill_graphs.last.clone(),
                        ops.launch_counts()))
            s.release(child.rid)
        for r in (a, b):
            s.release(r.rid)
        outs.append(got)
    return outs


def _same_prefills(strats, outs):
    """The two strategies' calls agree bitwise -- argmax, logits, launch
    counts -- and so do their pools, the sink block aside (the
    warm-ups write it)."""
    for (ng, lg, cg), (ne, le, ce) in zip(*outs):
        assert np.array_equal(ng, ne)
        assert torch.equal(lg, le)
        assert cg == ce
    sink = strats[0].sink
    for pg, pe in zip(strats[0]._pools(), strats[1]._pools()):
        others = [i for i in range(pg.shape[1]) if i != sink]
        assert torch.equal(pg[:, others], pe[:, others])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "minicpm3_4b",
                                  "qwen3_moe_30b_a3b"])
def test_cuda_replayed_prefill_matches_eager_prefill(cuda_device, arch):
    """Three rounds of one prefill bucket and (GQA) one suffix bucket:
    the first sighting runs eagerly, the second captures and replays,
    the third replays; every call equals the eager strategy's bitwise
    (argmax, logits, every block but the sink) with the same launch
    counts (#2 in the suffix's)."""
    cfg, params, strats = _prefill_strategies(cuda_device, arch)
    rng = np.random.default_rng(11)
    for rnd in range(3):
        _same_prefills(strats, _prefill_round(strats, params, cfg, rng,
                                              10 * rnd))
    st = strats[0]._prefill_graphs.stats
    assert st["graphs"] and st["recaptures"] == 0
    n = 2 if strats[0].supports_suffix_prefill else 1
    assert len(st["buckets"]) == n
    for b in st["buckets"].values():
        assert b == {"sightings": 3, "captures": 1, "replays": 2,
                     "eager": 1}
    assert not strats[1]._prefill_graphs.stats["graphs"]


@pytest.mark.cuda
def test_cuda_prefill_recaptures_after_pools_move(cuda_device):
    """Pools rebound through ``_set_streams`` after a bucket's capture:
    the next sighting drops the prefill graphs and captures each bucket
    once more, and every call stays the eager strategy's."""
    cfg, params, strats = _prefill_strategies(cuda_device, "gemma_2b")
    rng = np.random.default_rng(12)
    for rnd in range(4):
        if rnd == 2:
            for s in strats:
                _rebind_pools(s)
        _same_prefills(strats, _prefill_round(strats, params, cfg, rng,
                                              10 * rnd))
    st = strats[0]._prefill_graphs.stats
    assert st["recaptures"] == 1 and len(st["buckets"]) == 2
    for b in st["buckets"].values():
        assert b == {"sightings": 4, "captures": 2, "replays": 3,
                     "eager": 1}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _migration_run(model, params, device, mode, tmp_path):
    """Reduced gemma_2b on ``device``: a live migration after 3 steps and
    one preemption, or the disaggregated prefill of staggered arrivals;
    returns (tokens, the engine that decoded last)."""
    from repro_torch.serve.disagg import (DisaggregatedEngine, PrefillWorker,
                                          migrate_live)
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.traffic import RequestSource

    def engine():
        return Engine(model, params, slots=2, max_seq=64, num_blocks=24,
                      eos_id=-1, prefill_budget=None, device=device)

    rng = np.random.default_rng(21)
    base = rng.integers(2, 500, 16)
    prompts = [base, np.concatenate([base, rng.integers(2, 500, 3)]),
               rng.integers(2, 500, 11), rng.integers(2, 500, 7)]
    reqs = [Request(rid=i, prompt=p.copy(), max_new=8,
                    arrival_time=float(3 * i)) for i, p in enumerate(prompts)]
    if mode == "migrate":
        src = engine()
        for req in reqs:
            src.submit(req)
        for s in range(3):
            if s == 2:
                src.preempt_latest()
            src.step()
        eng, _ = migrate_live(src, engine, str(tmp_path / f"{device}.npz"))
        eng.run(max_steps=200)
        src.release_arena()
    else:
        pre = PrefillWorker(model, params, max_seq=64, num_blocks=24,
                            eos_id=-1, prefill_budget=None, device=device)
        dis = DisaggregatedEngine(pre, engine())
        dis.serve(RequestSource(reqs), max_steps=200)
        eng = dis.engine
        assert dis.handoffs == 4
    eng.arena.assert_quiescent()
    return {r.rid: list(r.generated) for r in eng.done}, eng


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["migrate", "handoff"])
def test_cuda_migration_and_handoff_match_cpu(cuda_device, mode, tmp_path):
    """A live migration and a prefill/decode handoff of reduced float32
    gemma_2b on the card, decode graphs on, give the CPU's tokens; the
    handoffs scatter into the decode engine's pools in place, so its
    graphs are never captured again."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config("gemma_2b").reduced())
    params = model.init(seed=3, device="cpu")
    want, _ = _migration_run(model, params, "cpu", mode, tmp_path)
    ops.reset_launch_counts()
    got, eng = _migration_run(model, _to(params, cuda_device), cuda_device,
                              mode, tmp_path)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert got == want and len(got) == 4
    st = eng.stats["decode_graphs"]
    assert st["graphs"] and st["recaptures"] == 0
    assert counts["gather_blocks"] > 0 and counts["scatter_blocks"] > 0


@pytest.mark.cuda
def test_cuda_restore_scatters_after_its_payload_is_dropped(cuda_device,
                                                           tmp_path):
    """``Arena.restore`` queues the scatter of a device payload from a
    pinned buffer and returns without waiting; with the payload dropped,
    the cycle collector run and the host allocator churned by pinned
    buffers of the same size, the pool still receives the saved bytes."""
    import gc

    from repro_torch.mem import Arena

    shape = (4, 16, 128, 256)
    blk = shape[0] * shape[2] * shape[3] * 4

    def arena():
        a = Arena()
        a.register_class("kv", num_blocks=16, block_nbytes=blk)
        cell = {"s": [torch.zeros(shape, device=cuda_device)]}
        a.transfers.register_executor(
            "kv", lambda: list(cell["s"]),
            lambda s: cell.update(s=list(s)))
        return a, cell

    a, cell = arena()
    m = a.mapping("kv", 0)
    m.ensure_capacity(8)
    ids = m.block_ids()
    g = torch.Generator(device="cpu").manual_seed(4)
    want = torch.randn((shape[0], 8) + shape[2:], generator=g)
    cell["s"][0][:, ids] = want.to(cuda_device)
    path = str(tmp_path / "snap.npz")
    a.snapshot(path, include_device=True)
    b, cell_b = arena()
    b.lease_blocks("kv", "pad", 5)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        restored = b.restore(path)
        gc.collect()
        for _ in range(8):
            junk = torch.empty((shape[0], 8) + shape[2:], pin_memory=True)
            junk.fill_(-1.0)
        del junk
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    new = restored[("kv", 0)].block_ids()
    assert new != ids
    assert torch.equal(cell_b["s"][0][:, new].cpu(), want)


# -- whisper and the VLM: the reduced models on the card against the CPU ----
def _encdec_run(model, params, dev, arch):
    """Prompt (InternVL2: image + 16 text tokens, then an 8-token text
    suffix through ``prefill_suffix``) and 8 greedy decode steps on
    ``dev``, inputs from a seeded numpy generator: ([logits], [tokens])."""
    from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager

    cfg = model.cfg
    B, bt = 2, cfg.kv_block_tokens
    rng = np.random.default_rng(4)

    def t(x):
        return torch.as_tensor(x).to(dev)

    toks = t(rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32))
    extra = (0.1 * rng.normal(size=(B, cfg.encoder.num_frames
                                    if cfg.encoder else
                                    cfg.num_image_tokens, cfg.d_model))
             ).astype(np.float32)
    max_seq = 64
    mgr = PagedKVManager(model.kv_config(max_seq=max_seq, batch=B))
    tables = t(np.stack([(mgr.admit(i, max_seq), mgr.device_table(i))[1]
                         for i in range(B)]))
    out = []
    if cfg.encoder is not None:
        st = model.init_state(B, max_seq, device=dev)
        st.self_kv.block_tables.copy_(tables)
        lg, st = model.prefill(params, toks, st, t(np.array([16, 11],
                                                            np.int32)),
                               frames=t(extra))
    else:
        st = PagedKVCache.create(model.kv_config(max_seq=max_seq, batch=B),
                                 B, device=dev)
        st.block_tables.copy_(tables)
        start = cfg.num_image_tokens + 16
        lg, st = model.prefill(params, toks, st,
                               t(np.full(B, start, np.int32)),
                               image_embeds=t(extra))
        out.append(lg)
        suffix = t(rng.integers(0, cfg.vocab_size, (B, bt)).astype(np.int32))
        lg, st = model.prefill_suffix(
            params, suffix, st, t(np.array([start + bt, start + 3], np.int32)),
            t(np.full(B, start, np.int32)),
            tables[:, start // bt:start // bt + 1].contiguous())
    out.append(lg)
    fed = []
    for _ in range(8):
        fed.append(lg.argmax(-1))
        lg, st = model.decode_step(params, fed[-1], st)
        out.append(lg)
    return [x.cpu() for x in out], [x.cpu() for x in fed]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_1b"])
def test_cuda_reduced_encdec_and_vlm_match_cpu(cuda_device, arch):
    """Reduced float32 whisper (cross attention over dense encoder K/V,
    #1 on the self attention) and InternVL2 (image prefix, #2 on a text
    suffix, #1 at G 2) on the card against the CPU: logits within 1e-4
    at every stage and step, identical greedy tokens, and the kernels
    launched on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config(arch).reduced(), max_positions=64)
    host = model.init(seed=3, device="cpu")
    card = _to(host, cuda_device)
    want, wtoks = _encdec_run(model, host, "cpu", arch)
    ops.reset_launch_counts()
    got, gtoks = _encdec_run(model, card, cuda_device, arch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    L = model.cfg.num_layers
    assert counts["paged_attention_append"] == 8 * L
    assert counts["paged_prefill_attention"] == (L if arch == "internvl2_1b"
                                                 else 0)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(gtoks, wtoks))


# -- training (card against the CPU; the AdamW kernel and the captured step) --
def _train_setup(arch, dtype="float32"):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2, seed=0))
    return model, data


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_moe_30b_a3b",
                                  "mamba2_370m"])
def test_cuda_reduced_loss_and_grads_match_cpu(cuda_device, arch):
    """The reduced float32 loss and every gradient leaf (``remat=True``)
    on the card against the CPU, within 1e-4 of each leaf's max."""
    from repro_torch.launch.steps import batch_to
    from repro_torch.tree import leaves as tree_leaves

    model, data = _train_setup(arch)
    host = model.init(seed=3, device="cpu")
    card = _to(host, cuda_device)
    out = {}
    for name, p, dev in (("cpu", host, "cpu"), ("cuda", card, cuda_device)):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = model.loss(p, batch_to(data.batch_at(0), dev), remat=True)
        loss.backward()
        out[name] = (float(loss.detach()), [t.grad.cpu() for t in leaves])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_resume_is_bitwise_identical(cuda_device, dtype, tmp_path):
    """``train.loop.run`` on the card: 8 steps against 4 + resume to 8
    give the same bits (every op of the step has a deterministic CUDA
    backward pass)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT
    from repro_torch.train.loop import TrainLoopConfig, run
    from repro_torch.tree import leaves as tree_leaves

    model, _ = _train_setup("gemma_2b", dtype)
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                      global_batch=2, seed=3)

    def go(name, total):
        params = model.init(seed=0, device=cuda_device)
        lcfg = TrainLoopConfig(total_steps=total, ckpt_every=4,
                               ckpt_dir=str(tmp_path / name), log_every=1000)
        return run(build_train_step(model, ocfg, device=cuda_device), params,
                   OPT.init_state(params), dcfg, lcfg, device=cuda_device,
                   log=lambda *_: None)

    full = go("a", 8)
    go("b", 4)
    resumed = go("b", 8)
    assert full["losses"][4:] == resumed["losses"]
    for x, y in zip(tree_leaves([full["params"], full["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


def _ulps(a, b):
    """The largest distance of ``a`` from ``b`` in units in the last place
    of their (float32 or bfloat16) dtype: their bit patterns as ordered
    integers."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int16
    ia, ib = (t.contiguous().view(it).long() for t in (a, b))
    top = 1 << (8 * a.element_size() - 1)
    ia = torch.where(ia < 0, -top - ia, ia)
    ib = torch.where(ib < 0, -top - ib, ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,view", [(1, None), (7, None), (4099, None),
                                    ((1 << 20) + 3, None),
                                    (4099, "offset"), (4096, "strided")])
def test_cuda_adamw_update_matches_plain_version(cuda_device, dtype, n,
                                                 view):
    """``ops.adamw_update`` (the kernel) against ``ref.adamw_update_ref``
    on the card: m and v within 1 float32 ulp, p within 1 ulp of its
    dtype; a view one element off the 16-byte grid (the scalar loop) and
    a strided slice (updated through a copy written back) too; one
    launch counted."""
    from repro_torch.optim.adamw import AdamWConfig

    g = torch.Generator(device=cuda_device).manual_seed(n)
    size = n + 1 if view == "offset" else n
    base = [torch.randn(size, generator=g, device=cuda_device) for _ in
            range(4)]
    base[0], base[1] = base[0].to(dtype), base[1].to(dtype)
    base[3] = base[3].abs() * 1e-2
    if view == "offset":
        leaf = [t[1:] for t in base]
    elif view == "strided":
        leaf = [t.view(64, 64)[:, 16:48] for t in base]
    else:
        leaf = base
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda_device)
          for x in (0.5, 1e-3, 0.19, 0.0975)]
    cfg = AdamWConfig()
    orig = [t.clone() for t in base]
    want = [t.clone() for t in leaf]
    ref.adamw_update_ref(want[0], want[1], want[2], want[3], *sc, cfg)
    ops.reset_launch_counts()
    ops.adamw_update(*leaf, *sc, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw_update"] == 1
    assert _ulps(leaf[0], want[0]) <= 1
    assert _ulps(leaf[2], want[2]) <= 1 and _ulps(leaf[3], want[3]) <= 1
    if view == "strided":
        for k in (0, 2, 3):
            a, b = base[k].view(64, 64), orig[k].view(64, 64)
            assert torch.equal(a[:, :16], b[:, :16])
            assert torch.equal(a[:, 48:], b[:, 48:])


def _graph_run(model, ocfg, device, batches, graph):
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT

    params = model.init(seed=0, device=device)
    ost = OPT.init_state(params)
    step = build_train_step(model, ocfg, device=device, graph=graph)
    ops.reset_launch_counts()
    losses = []
    for b in batches:
        params, ost, mets = step(params, ost, b)
        losses.append(float(mets["loss"]))
    return params, ost, losses, step.stats(), ops.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m"])
def test_cuda_captured_step_equals_eager_step(cuda_device, arch):
    """4 steps of the reduced float32 model: eager, and 2 eager steps +
    the capture (which replays once) + a replay, bit for bit; the
    launch counts equal."""
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    model, data = _train_setup(arch)
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    batches = [data.batch_at(i) for i in range(4)]
    pe, oe, le, se, ce = _graph_run(model, ocfg, cuda_device, batches, False)
    pg, og, lg, sg, cg = _graph_run(model, ocfg, cuda_device, batches, True)
    assert se["eager_steps"] == 4 and se["captures"] == 0
    assert (sg["eager_steps"], sg["captures"], sg["replays"]) == (2, 1, 2)
    assert le == lg and ce == cg
    assert ce["adamw_update"] == 4 * len(tree_leaves(pe))
    for a, b in zip(tree_leaves([pe, oe]), tree_leaves([pg, og])):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_cuda_step_recaptures_for_new_shapes_and_tensors(cuda_device):
    """A new batch shape takes its own warm-up and capture; parameters
    at other addresses recapture (never a stale replay)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT

    model, data = _train_setup("gemma_2b")
    short = SyntheticLM(DataConfig(vocab_size=model.cfg.vocab_size,
                                   seq_len=16, global_batch=2, seed=1))
    step = build_train_step(model, OPT.AdamWConfig(), device=cuda_device)
    params = model.init(seed=0, device=cuda_device)
    ost = OPT.init_state(params)
    for i in range(3):
        params, ost, _ = step(params, ost, data.batch_at(i))
    for i in range(4):
        params, ost, _ = step(params, ost, short.batch_at(i))
    st = step.stats()
    assert (st["captures"], st["recaptures"], st["eager_steps"],
            st["replays"]) == (2, 0, 4, 3)
    other = model.init(seed=0, device=cuda_device)
    ost2 = OPT.init_state(other)
    other, ost2, m = step(other, ost2, data.batch_at(0))
    st = step.stats()
    assert (st["captures"], st["recaptures"]) == (3, 1)
    assert int(ost2.step) == 1 and np.isfinite(float(m["loss"]))


@pytest.mark.cuda
def test_cuda_captured_step_does_not_sync(cuda_device):
    """The capture (the step's body) and a replay call under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT

    model, data = _train_setup("qwen3_moe_30b_a3b")
    step = build_train_step(model, OPT.AdamWConfig(), device=cuda_device)
    params = model.init(seed=0, device=cuda_device)
    ost = OPT.init_state(params)
    for i in range(2):
        params, ost, _ = step(params, ost, data.batch_at(i))
    body = step.graphs.body

    def strict(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    step.graphs.body = strict
    params, ost, _ = step(params, ost, data.batch_at(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, ost, m = step(params, ost, data.batch_at(3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert step.stats()["captures"] == 1 and step.stats()["replays"] == 2
    assert np.isfinite(float(m["loss"]))


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_the_cpu(cuda_device, tmp_path):
    """A checkpoint written from CUDA tensors (bf16 parameters, float32
    moments, the int32 step) restores onto the CPU bit for bit."""
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.tree import leaves as tree_leaves, tree_map

    model, _ = _train_setup("gemma_2b", "bfloat16")
    params = model.init(seed=1, device=cuda_device)
    ost = OPT.init_state(params)
    ost.mu["embed"].normal_()
    tree = {"params": params, "opt": ost}
    CKPT.save(str(tmp_path), 5, tree, block_bytes=1 << 16)
    like = tree_map(lambda t: torch.empty(0), tree)
    back = CKPT.restore(str(tmp_path), 5, like)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert y.device.type == "cpu" and y.dtype == x.dtype
        assert torch.equal(x.cpu(), y)


# -- #1 at large blocks, and Fig. 5's bench on the card ----------------------
@pytest.mark.cuda
@pytest.mark.parametrize("BT", [256, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_append_at_large_blocks_matches_plain_version(cuda_device,
                                                           dtype, BT):
    """#1 at gemma-2b's widths (1 kv head, G 8, head_dim 256) over 2048
    keys a row in blocks of 256 and 2048 tokens, identity tables, B 8:
    a whole block's stage would overflow shared memory, so the kernel
    stages pieces of it.  Lengths at split and piece edges (every
    multiple of 64 and one either side; 2048 drops the write); output
    and pools against the plain version."""
    rng = np.random.default_rng(26)
    B, KVH, G, HD, n = 8, 1, 8, 256, 2048
    MB = n // BT

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    kp, vp = t((B * MB, BT, KVH, HD)), t((B * MB, BT, KVH, HD))
    tables = torch.arange(B * MB, dtype=torch.int32,
                          device=cuda_device).reshape(B, MB)
    edges = sorted({min(max(64 * k + d, 0), n) for k in range(n // 64 + 1)
                    for d in (-1, 0, 1)})
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for i in range(0, len(edges), B):
        lens = torch.tensor((edges[i:i + B] + edges[:B])[:B],
                            dtype=torch.int32, device=cuda_device)
        q, kn, vn = t((B, KVH, G, HD)), t((B, KVH, HD)), t((B, KVH, HD))
        ro, rk, rv = ref.paged_attention_append_ref(q, kn, vn, kp.clone(),
                                                    vp.clone(), tables, lens)
        o, k, v = ops.paged_attention_append(q, kn, vn, kp.clone(),
                                             vp.clone(), tables, lens)
        torch.cuda.synchronize()
        assert torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol), \
            lens.tolist()
        assert torch.equal(k, rk) and torch.equal(v, rv), lens.tolist()


@pytest.mark.cuda
def test_cuda_end2end_reduced_rows_match_cpu(cuda_device):
    """``bench.end2end``'s reduced rows (float32, B 8, ctx 128, every
    layout) on the card -- each step replayed from a captured graph and
    timed -- against the same rows on the CPU: each layout's logits
    within 1e-5 of max|logit|, and the bench's own gates (layouts equal,
    the planted fault trips) hold on both."""
    from repro_torch.bench import end2end

    model, host = end2end.row_model("reduced", "cpu")
    _, B, max_seq, ctx = end2end.ROWS["reduced"]
    want = end2end.run_row("reduced", model, host, "cpu", B=B,
                           max_seq=max_seq, ctx=ctx, timed=False)
    got = end2end.run_row("reduced", model, _to(host, cuda_device),
                          cuda_device, B=B, max_seq=max_seq, ctx=ctx)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for a, b in zip(got[:-1], want[:-1]):
        assert end2end.gap(a["logits"].cpu(), b["logits"]) <= 1e-5, a["name"]
        assert a["device_ms"] > 0 and a["attn_ms"] > 0
    assert got[-1]["trips"] and want[-1]["trips"]
