"""The split-latent MLA pool (``mla_latent_tp``) of the PyTorch port
against the JAX package.

Under ``mla_latent_tp`` an MLA model keeps its paged pool in two
streams, the ``kv_lora`` stream and the shared rope keys, and decodes
through ``attention.mla_decode_split``: two kernels, the partial scores
(``paged_latent_scores``) and the softmax with the self term applied to
the lora lanes (``paged_latent_values``), whose plain versions run here.
Reduced DeepSeek-V2-Lite and MiniCPM3-4B in float32:

* one layer of ``mla_decode_split`` against the reference's, with its
  ``write_token_paged`` of both streams, at ``dp_groups`` 1 and 2 (1e-5
  of the output's scale; the pools' rows are the values written);
* the kernels' plain versions against the reference's jnp lines (its
  gather, masked softmax and ``_merge_self``), with NULL table entries,
  a row with no cached key and 128-token blocks (3e-6), and the sum of
  two lane pieces' partial scores (the rope term in one) equal to the
  whole stream's, each piece's values the whole's lanes (the model
  axis's algebra);
* ``kv_config``, the pools' shapes and ``swap_nbytes_per_block`` at the
  published widths against the reference's;
* ``DecoderLM``'s prefill, decode steps and fused tail against the JAX
  ``DecoderLM`` in the same mode (1e-5 relative on logits, equal greedy
  tokens, the pools' streams);
* the engine's scripted workload on a pool small enough to preempt and
  swap, against the JAX engine: tokens, preemptions, the per-step swap
  ledger (whole blocks of ``swap_nbytes_per_block``), steps; a shared
  prefix's COW copy, a forced preemption and a compaction of both
  streams against the JAX engine, a live migration against an unmoved
  control, and an ``Arena`` snapshot whose restored blocks hold both
  streams' bytes (the rope stream 8 lanes wide beside the lora
  stream's 32);
* the mesh's serve and prefill steps on thread ranks ((1, 2), (1, 3),
  (2, 2)) against the port's one-device steps within 1e-5 of max
  |logit|: every rank's lora piece, the rope stream whole, the scores'
  all-reduce.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.models import attention as JA
from repro.models.api import build_model as jbuild_model
from repro.models.lm import write_token_paged
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as A
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.models.lm import layer_params
from repro_torch.serve.disagg import migrate_live
from repro_torch.serve.engine import Engine, Request
from test_torch_engine import assert_same, drive, preempt_and_compact

torch.set_num_threads(1)

ARCHS = ["deepseek_v2_lite_16b", "minicpm3_4b"]
LAYER_TOL = 1e-5        # of the output's max |y|
KERNEL_TOL = 3e-6       # float32, sums in another order
MODEL_TOL = 1e-5        # relative to max |logit|
MESH_TOL = 1e-5         # of max |logit|


def _split(cfg):
    return dataclasses.replace(cfg, mla_latent_tp=True)


_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, torch model, torch params, torch cfg) of the
    reduced float32 model in split mode, the weights converted from the
    reference's."""
    if arch not in _PAIRS:
        jcfg = _split(jget_config(arch).reduced())
        cfg = _split(get_config(arch).reduced())
        jm = jbuild_model(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _PAIRS[arch] = (jm, jp, build_model(cfg), tp, cfg)
    return _PAIRS[arch]


def _close(a, b, tol, scale=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    s = float(np.abs(b).max()) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(s, 1e-30))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_split_one_layer_matches_jax(arch, dp):
    """One layer: y against the reference's ``mla_decode_split`` and both
    pools against its ``write_token_paged`` of ``c_new`` and
    ``rope_new``; rows of lengths 0, mid-block and a block's end, one
    with NULL entries past its end.  With ``dp_groups`` 2 the reference
    takes group-local tables and the port the global ids
    (``PagedKVCache.global_ids``)."""
    jm, jp, tm, tp, cfg = _pair(arch)
    m = cfg.mla
    rng = np.random.default_rng(21 + dp)
    B, BT, MB = 4, cfg.kv_block_tokens, 3
    NB = B * MB + 4
    c_pool = rng.standard_normal((NB, BT, m.kv_lora_rank)).astype(np.float32)
    r_pool = rng.standard_normal((NB, BT, m.qk_rope_head_dim)).astype(
        np.float32)
    nbl = NB // dp
    tables = np.concatenate([rng.permutation(nbl)[: (B // dp) * MB].reshape(
        B // dp, MB) for _ in range(dp)]).astype(np.int32)
    tables[0, 1:] = -1
    lens = np.array([0, 13, 2 * BT - 1, BT], np.int32)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda t: t[1], jp["layers"]["attn"])
    jcfg = _split(jget_config(arch).reduced())
    jy, (jc, jr) = JA.mla_decode_split(
        jlp, jnp.asarray(x), jcfg, jnp.asarray(c_pool), jnp.asarray(r_pool),
        jnp.asarray(tables), jnp.asarray(lens), dp_groups=dp)
    jt = jnp.asarray(tables)
    jcp = write_token_paged(jnp.asarray(c_pool), jc, jt, jnp.asarray(lens),
                            BT, dp)
    jrp = write_token_paged(jnp.asarray(r_pool), jr, jt, jnp.asarray(lens),
                            BT, dp)
    kv = tm.kv_config(MB * BT, NB, B, dp_groups=dp)
    view = PagedKVCache(torch.zeros(0), None, torch.from_numpy(tables),
                        torch.from_numpy(lens), kv)
    glob = view.global_ids(torch.from_numpy(tables))
    tc, tr = torch.from_numpy(c_pool.copy()), torch.from_numpy(r_pool.copy())
    ty = A.mla_decode_split(layer_params(tp["layers"], 1)["attn"],
                            torch.from_numpy(x), cfg, tc, tr, glob,
                            torch.from_numpy(lens))
    _close(ty, jy, LAYER_TOL)
    _close(tc, jcp, LAYER_TOL)
    _close(tr, jrp, LAYER_TOL)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
def _jnp_split(q_lat, q_r, c_pool, r_pool, tables, lens, c_new, r_new):
    """The reference's lines of ``mla_decode_split`` from the gather to
    the merge (``repro/models/attention.py:486-513``), queries scaled."""
    B, H, L = q_lat.shape
    tbl = jnp.maximum(tables, 0)
    MB, BT = tbl.shape[1], c_pool.shape[1]
    k_lora = JA._grouped_gather(c_pool, tbl, 1).reshape(B, MB * BT, L)
    k_rope = JA._grouped_gather(r_pool, tbl, 1).reshape(B, MB * BT, -1)
    s = (jnp.einsum("bhl,bsl->bhs", q_lat, k_lora) +
         jnp.einsum("bhr,bsr->bhs", q_r, k_rope))
    pos = jnp.arange(MB * BT)[None, :]
    valid = (pos < lens[:, None])[:, None, :]
    s = jnp.where(valid, s, JA._NEG)
    mx = jnp.max(s, axis=-1)
    pr = jnp.exp(s - mx[..., None]) * valid
    l = jnp.sum(pr, axis=-1)
    o = jnp.einsum("bhs,bsl->bhl", pr, k_lora) / \
        jnp.maximum(l, 1e-30)[..., None]
    s_self = (jnp.einsum("bhl,bl->bh", q_lat, c_new) +
              jnp.einsum("bhr,br->bh", q_r, r_new))
    return JA._merge_self(o[:, None], l[:, None], mx[:, None],
                          s_self[:, None], c_new[:, None, None, :])[:, 0]


@pytest.mark.parametrize("H,L,R,BT", [(16, 64, 16, 8), (40, 32, 8, 16),
                                      (4, 48, 8, 128)])
def test_split_kernels_plain_versions_match_jnp_lines(H, L, R, BT):
    """Pass 1 then pass 2 of the plain versions against the reference's
    lines: NULL entries past a row's end, a row with no cached key (its
    output is ``c_new``), 128-token blocks; pass 1 writes 0 past each
    row's length and the self score in its last column."""
    rng = np.random.default_rng(H + BT)
    B, MB = 3, 3
    NB = B * MB + 1
    f = np.float32
    q_lat = rng.standard_normal((B, H, L)).astype(f)
    q_r = rng.standard_normal((B, H, R)).astype(f)
    c_pool = rng.standard_normal((NB, BT, L)).astype(f)
    r_pool = rng.standard_normal((NB, BT, R)).astype(f)
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    tables[1, 1:] = -1
    lens = np.array([2 * BT + 3, BT - 1, 0], np.int32)
    c_new = rng.standard_normal((B, L)).astype(f)
    r_new = rng.standard_normal((B, R)).astype(f)
    t = [torch.from_numpy(a) for a in (q_lat, q_r, c_pool, r_pool, tables,
                                       lens, c_new, r_new)]
    s = ref.paged_latent_scores_ref(*t)
    assert s.shape == (B, H, MB * BT + 1) and s.dtype == torch.float32
    for b in range(B):
        assert not s[b, :, lens[b]:MB * BT].any()
    o = ref.paged_latent_values_ref(s, t[2], t[4], t[5], t[6])
    want = _jnp_split(*(jnp.asarray(a) for a in (q_lat, q_r, c_pool, r_pool,
                                                 tables, lens, c_new, r_new)))
    _close(o, want, KERNEL_TOL)
    np.testing.assert_allclose(o[2].numpy(), np.broadcast_to(c_new[2],
                                                            (H, L)),
                               rtol=1e-6)
    assert torch.equal(ops.paged_latent_values(s, t[2], t[4], t[5], t[6]), o)


def test_split_kernels_sum_over_lane_pieces():
    """The model axis's algebra on the plain versions: the partial scores
    of two lane pieces of the lora stream, the rope term in the first
    only, sum to the whole stream's scores, and pass 2 on that sum gives
    each piece's lanes of the whole stream's output."""
    rng = np.random.default_rng(5)
    B, H, L, R, BT, MB = 2, 8, 64, 16, 8, 4
    NB = B * MB
    f = np.float32
    t = [torch.from_numpy(a) for a in (
        rng.standard_normal((B, H, L)).astype(f),
        rng.standard_normal((B, H, R)).astype(f),
        rng.standard_normal((NB, BT, L)).astype(f),
        rng.standard_normal((NB, BT, R)).astype(f),
        np.arange(NB, dtype=np.int32).reshape(B, MB),
        np.array([27, 5], np.int32),
        rng.standard_normal((B, L)).astype(f),
        rng.standard_normal((B, R)).astype(f))]
    q_lat, q_r, c_pool, r_pool, tables, lens, c_new, r_new = t
    whole = ref.paged_latent_scores_ref(*t)
    h = L // 2
    p0 = ops.paged_latent_scores(q_lat[..., :h].contiguous(), q_r,
                                 c_pool[..., :h].contiguous(), r_pool,
                                 tables, lens, c_new[:, :h], r_new)
    p1 = ops.paged_latent_scores(q_lat[..., h:].contiguous(), None,
                                 c_pool[..., h:].contiguous(), None, tables,
                                 lens, c_new[:, h:], None)
    _close(p0 + p1, whole, KERNEL_TOL)
    o = ref.paged_latent_values_ref(whole, c_pool, tables, lens, c_new)
    for sl in (slice(0, h), slice(h, L)):
        piece = ops.paged_latent_values(p0 + p1, c_pool[..., sl].contiguous(),
                                        tables, lens, c_new[:, sl])
        _close(piece, o[..., sl], KERNEL_TOL, scale=float(o.abs().max()))


def test_split_kernel_wrappers_check_shapes_and_count_nothing_on_cpu():
    B, H, L, R, BT, MB = 2, 4, 16, 8, 8, 2
    q = torch.zeros(B, H, L)
    c = torch.zeros(B * MB, BT, L)
    r = torch.zeros(B * MB, BT, R)
    tb = torch.zeros(B, MB, dtype=torch.int32)
    ln = torch.ones(B, dtype=torch.int32)
    ops.reset_launch_counts()
    s = ops.paged_latent_scores(q, torch.zeros(B, H, R), c, r, tb, ln,
                                torch.zeros(B, L), torch.zeros(B, R))
    ops.paged_latent_values(s, c, tb, ln, torch.zeros(B, L))
    assert ops.launch_counts()["paged_latent_scores"] == 0
    assert ops.launch_counts()["paged_latent_values"] == 0
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.paged_latent_scores(q, None, c[..., :8], None, tb, ln,
                                torch.zeros(B, L), None)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.paged_latent_scores(q, torch.zeros(B, H, R), c, r, tb, ln,
                                torch.zeros(B, L), None)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.paged_latent_values(s[..., :-1], c, tb, ln, torch.zeros(B, L))
    meta = ops.paged_latent_values(s.to("meta"), c.to("meta"),
                                   tb.to("meta"), ln.to("meta"),
                                   torch.zeros(B, L, device="meta"))
    assert meta.shape == (B, H, L) and meta.device.type == "meta"


def test_latent_bills_hold_to_touched_bytes():
    """The two kernels' bills (``cost/kernels.py``, at the table's
    capacity) against the bytes the cost-model bench's latent case makes
    them touch (``bench/cost_model.latent_touched_bytes``): equal where
    every row fills its table, capacity over valid keys at the bench's
    lengths (within its range), and a bill of the whole pool outside."""
    from repro_torch.bench import cost_model as CM
    from repro_torch.cost import kernels as KB
    B, BT, MB = CM.B, CM.BT, CM.MB
    H, L, R = CM.LAT_HEADS, CM.LORA, CM.ROPE
    q_lat, q_r = torch.zeros(B, H, L), torch.zeros(B, H, R)
    pool = torch.zeros(1, BT, L)
    bill = (KB.paged_latent_scores(B, H, L, R, MB, BT, 4).bytes
            + KB.paged_latent_values(B, H, L, MB, BT, 4).bytes)
    full = torch.full((B,), MB * BT, dtype=torch.int32)
    assert CM.latent_touched_bytes(q_lat, q_r, pool, full, BT) == bill
    lens = torch.tensor(CM.APPEND_LENS, dtype=torch.int32)
    ratio = bill / CM.latent_touched_bytes(q_lat, q_r, pool, lens, BT)
    assert 1.2 < ratio < 1.4 and CM.RATIO_LO <= ratio <= CM.RATIO_HI
    whole = bill + (CM.POOL_FACTOR - 1) * B * MB * BT * (2 * L + R) * 4
    assert whole / CM.latent_touched_bytes(q_lat, q_r, pool, lens, BT) \
        > CM.RATIO_HI


# ---------------------------------------------------------------------------
# the pool's config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bt", [64, 128])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_kv_config_and_bytes_match_reference(arch, bt):
    cfg = dataclasses.replace(_split(get_config(arch)), kv_block_tokens=bt)
    jcfg = dataclasses.replace(_split(jget_config(arch)), kv_block_tokens=bt)
    tm, jm = build_model(cfg), jbuild_model(jcfg)
    tkv = tm.kv_config(max_seq=1024, num_blocks=24)
    jkv = jm.kv_config(max_seq=1024, num_blocks=24)
    m = cfg.mla
    assert (tkv.head_dim, tkv.latent_rope) == (jkv.head_dim, jkv.latent_rope) \
        == (m.kv_lora_rank, m.qk_rope_head_dim)
    assert tkv.pool_shape() == jkv.pool_shape()
    assert tkv.swap_nbytes_per_block() == jkv.swap_nbytes_per_block() == \
        cfg.num_layers * bt * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    meta = tm.decode_state_specs(4, 1024, num_blocks=24)
    js = jm.decode_state_specs(4, 1024, num_blocks=24)
    assert meta.k_pool.device.type == "meta"
    assert tuple(meta.k_pool.shape) == js.k_pool.shape
    assert tuple(meta.v_pool.shape) == js.v_pool.shape == (
        *tkv.pool_shape()[:-1], m.qk_rope_head_dim)
    # the one-stream pool is unchanged by the new field
    whole = build_model(get_config(arch)).kv_config(max_seq=1024)
    assert whole.latent_rope == 0 and whole.v_shape() is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _tables(kv, B, tokens):
    mgr = PagedKVManager(kv)
    return np.stack([(mgr.admit(i, tokens), mgr.device_table(i))[1]
                     for i in range(B)])


@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_decode_and_fused_tail_match_jax(arch):
    """Prefill of two prompts (lengths 16 and 11), then 6 decode steps and
    6 steps of the fused tail: logits within 1e-5 relative of the JAX
    ``DecoderLM``'s in the same mode, greedy tokens equal, both streams
    of the pool the reference's."""
    jm, jp, tm, tp, cfg = _pair(arch)
    B, S, steps = 2, 16, 6
    max_seq = S + 2 * steps + 1
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jkv, tkv = jm.kv_config(max_seq=max_seq, batch=B), \
        tm.kv_config(max_seq=max_seq, batch=B)
    tb = _tables(tkv, B, max_seq)
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tb))
    tc = PagedKVCache.create(tkv, B, device="cpu")
    assert tc.v_pool is not None and tc.k_pool.shape[-1] == \
        cfg.mla.kv_lora_rank
    tc.block_tables.copy_(torch.as_tensor(tb))
    lens = np.array([S, 11], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                        jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.as_tensor(toks), tc, torch.as_tensor(lens))
    _close(tl, jl, MODEL_TOL)
    for _ in range(steps):
        nxt = np.asarray(jl.argmax(-1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.as_tensor(nxt), tc)
        _close(tl, jl, MODEL_TOL)
    jt, tt = jnp.argmax(jl, -1), tl.argmax(-1)
    empty = np.zeros(0, np.int32)
    for _ in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_fused(jp, jt, jc, jnp.asarray(empty),
                                 jnp.zeros((0, jkv.max_blocks_per_seq),
                                           jnp.int32), jnp.asarray(empty))
        tt, tc = tm.decode_fused(tp, tt, tc, torch.as_tensor(empty),
                                 torch.zeros((0, tkv.max_blocks_per_seq),
                                             dtype=torch.int32),
                                 torch.as_tensor(empty))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    for mine, theirs in ((tc.k_pool, jc.k_pool), (tc.v_pool, jc.v_pool)):
        _close(mine, theirs, MODEL_TOL)


def test_split_engine_workload_preempts_and_swaps_like_jax():
    """Reduced DeepSeek-V2-Lite split, 2 slots over 10 blocks, four
    prompts of 5, 9, 3 and 12 tokens, 30 new tokens each: the pool runs
    out, so the engines
    preempt and swap whole blocks of both streams; tokens, preemptions,
    the per-step swap ledger and steps equal the JAX engine's, and the
    tokens equal the unsplit port's on the same weights."""
    pair = _pair("deepseek_v2_lite_16b")
    cfg = pair[4]
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(2, cfg.vocab_size, size=n), 30)
            for n in (5, 9, 3, 12)]
    kw = dict(slots=2, max_seq=64, num_blocks=10, watermark=1)
    j, t = (drive(pkg, pair, reqs, kw) for pkg in ("jax", "torch"))
    assert_same(j, t)
    eng = t["engine"]
    assert eng.mgr.config.latent_rope == cfg.mla.qk_rope_head_dim
    assert t["preemptions"] >= 1
    block = eng.mgr.config.swap_nbytes_per_block()
    outs, ins, out_b, in_b = t["ledger"][-1]
    assert outs >= 1 and ins >= 1 and out_b == in_b
    assert out_b % block == 0 and out_b > 0
    whole = (pair[0], pair[1], build_model(dataclasses.replace(
        cfg, mla_latent_tp=False)), pair[3], cfg)
    assert drive("torch", whole, reqs, kw)["tokens"] == t["tokens"]


def _split_engine(pair, **kw):
    jm, jp, tm, tp, _ = pair
    return Engine(tm, tp, device="cpu", eos_id=-1, prefill_budget=None,
                  **{**dict(slots=3, max_seq=64, num_blocks=24), **kw})


def test_split_pools_through_cow_compaction_migration_and_snapshot(tmp_path):
    """The transfer plane carries the rope stream beside the lora stream:
    a prefix-sharing workload (one prompt an exact prefix ending mid-block,
    so its first divergent write fulfils a COW copy of both streams)
    with a forced preemption and a compaction equals the JAX engine's;
    a live migration mid-decode gives the unmoved control's tokens; a
    snapshot restores every device block of both streams bytewise."""
    pair = _pair("deepseek_v2_lite_16b")
    cfg = pair[4]
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, size=12)
    reqs = [(base, 10), (rng.randint(2, cfg.vocab_size, size=9), 6),
            (base, 6),
            (np.concatenate([base, rng.randint(2, cfg.vocab_size, size=6)]),
             6),
            (rng.randint(2, cfg.vocab_size, size=5), 6)]
    kw = dict(slots=3, max_seq=64, num_blocks=20, watermark=1)
    j, t = (drive(pkg, pair, reqs, kw, hook=preempt_and_compact(3))
            for pkg in ("jax", "torch"))
    assert_same(j, t)
    assert t["cow_copies"] >= 1 and t["compactions"] >= 1
    assert t["state"]["forced"] and t["state"]["moved"] > 0

    def submit(eng):
        for rid, (prompt, n) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt.copy(), max_new=n))
        for _ in range(4):
            eng.step()

    control = _split_engine(pair)
    submit(control)
    control.run(max_steps=400)
    src = _split_engine(pair)
    submit(src)
    dst, sess = migrate_live(src, lambda: _split_engine(pair),
                             str(tmp_path / "mig.npz"))
    dst.run(max_steps=400)
    dst.arena.assert_quiescent()
    assert {r.rid: list(r.generated) for r in dst.done} == \
        {r.rid: list(r.generated) for r in control.done}
    src.release_arena()
    eng = _split_engine(pair)
    submit(eng)
    eng.transfers.drain()
    path = str(tmp_path / "snap.npz")
    eng.arena.snapshot(path, include_device=True)
    new = _split_engine(pair)
    restored = new.arena.restore(path)
    cls = eng.strategy.mgr.pool_class
    streams = eng.strategy._streams()
    assert [s.shape[-1] for s in streams] == [cfg.mla.kv_lora_rank,
                                             cfg.mla.qk_rope_head_dim]
    for rid in range(len(reqs)):
        m = eng.arena.find_mapping(cls, rid)
        if m is None or m.placement != "device":
            continue
        old, ids = m.block_ids(), restored[(cls, rid)].block_ids()
        for a, b in zip(streams, new.strategy._streams()):
            assert torch.equal(a[:, old], b[:, ids])
    for e in (control, dst, eng, new):
        e.release_arena()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
MB_, NB_, B_, S_ = 4, 16, 4, 16


def _mesh_tables():
    rng = np.random.default_rng(3)
    t = np.zeros((B_, MB_), np.int32)
    for g in range(2):
        t[2 * g:2 * g + 2] = rng.permutation(NB_ // 2).reshape(2, -1)
    return t


def _steps_inputs(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (B_, S_)).astype(np.int32)
    return toks, np.asarray([S_, 11, 7, S_], np.int32)


def _glob(model, dp):
    st = PagedKVCache.create(model.kv_config(MB_ * 8, NB_, B_, dp_groups=dp),
                             B_, device="cpu")
    st.block_tables.copy_(torch.as_tensor(_mesh_tables()))
    return st


def _one_device(model, tp, dp, n=3):
    toks, lens = _steps_inputs(model.cfg)
    st = _glob(model, dp)
    last, st = model.prefill(tp, torch.as_tensor(toks), st,
                             torch.as_tensor(lens))
    out = [last]
    for _ in range(n):
        lg, st = model.decode_step(tp, out[-1].argmax(-1), st)
        out.append(lg)
    return torch.stack(out), [o.argmax(-1) for o in out[:-1]]


@pytest.mark.parametrize("arch,shape", [
    ("deepseek_v2_lite_16b", (1, 2)), ("deepseek_v2_lite_16b", (1, 3)),
    ("deepseek_v2_lite_16b", (2, 2)), ("minicpm3_4b", (1, 2))])
def test_split_mesh_steps_match_one_device(arch, shape):
    """The serve and prefill steps on thread ranks: every rank holds every
    head, ``wk_b``/``wv_b`` and the pool's lora stream split on their
    lora rows/lanes where they divide the axis (at 3 the stream and
    weights stay whole, and no all-reduce runs in decode's attention),
    the rope stream whole; the gathered logits within 1e-5 of max
    |logit| of the one-device steps, greedy tokens equal."""
    jm, jp, tm, tp, cfg = _pair(arch)
    dp = shape[0]
    want, fed = _one_device(tm, tp, dp)
    toks, lens = _steps_inputs(cfg)
    lora, tpn = cfg.mla.kv_lora_rank, shape[1]
    piece = lora // tpn if lora % tpn == 0 else lora

    def fn(mesh):
        glob = _glob(tm, dp)
        prefill = STEPS.build_prefill_step(tm, mesh=mesh, state_example=glob)
        serve = STEPS.build_serve_step(tm, mesh=mesh, state_example=glob)
        assert serve.in_shardings == prefill.in_shardings
        assert serve.rules["attn_heads"] is None
        params = STEPS.shard_params(mesh, tp, serve.in_shardings)
        attn = params["layers"]["attn"]
        state = STEPS.shard_state(mesh, glob, cfg)
        shapes = (tuple(attn["wk_b"].shape[1:]), tuple(attn["wo"].shape[1:]),
                  state.k_pool.shape[-1], state.v_pool.shape[-1],
                  state.config.head_dim)
        rows = STEPS.shard_batch(mesh, {"t": toks, "l": lens})
        last, state = prefill(params, torch.as_tensor(rows["t"]), state,
                              torch.as_tensor(rows["l"]))
        out = [last]
        mesh.stats.reset()
        for f in fed:
            mine = STEPS.shard_batch(mesh, {"f": f.numpy()})["f"]
            lg, state = serve(params, torch.as_tensor(mine), state)
            out.append(lg)
        got = torch.stack([STEPS.gather_logits(mesh, o, cfg.vocab_size)
                           for o in out])
        return got.numpy(), shapes, dict(mesh.stats.calls)

    res = run_ranks(shape, fn, device="cpu")
    m = cfg.mla
    H = cfg.num_heads
    for got, shapes, calls in res:
        assert shapes == ((piece, H * m.qk_nope_head_dim),
                          (H * m.v_head_dim, cfg.d_model), piece,
                          m.qk_rope_head_dim, piece)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=MESH_TOL * float(want.abs().max()))
        assert np.array_equal(got.argmax(-1), want.argmax(-1).numpy())
        if piece != lora:
            # per layer and step: the scores' sum and the output's
            assert calls["all_reduce"] >= 2 * cfg.num_layers * len(fed)
