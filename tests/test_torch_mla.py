"""The MLA path of the PyTorch port against the JAX package.

Covers the second slice of the port: MiniCPM3-4B served from a paged
latent KV pool.

* ``paged_attention`` (the plain version the wrapper runs on CPU
  tensors, and the oracle of the CUDA kernel on the card) against the
  Pallas ``paged_attention`` in interpret mode and the jnp oracle, on
  the shapes of ``tests/test_kernels.py`` plus G = 40 query heads, NULL
  table entries and the MLA latent mode.  Tolerances: float32 3e-5
  (sums in another order), bfloat16 3e-2 (identical bf16 inputs, float32
  accumulation on both sides, one rounding of the output).
* The latent ``PagedKVConfig``/``PagedKVCache`` against the reference's.
* ``mla_decode`` on one layer against the JAX ``mla_decode`` +
  ``write_token_paged``, in float32 and in bfloat16 (3e-2, and no less
  precise than the reference against its own float32 layer); reduced MiniCPM3-4B (float32) forward logits,
  prefill then ``decode_step`` logits at every step and greedy tokens
  against the JAX ``DecoderLM``, with 1e-4 as in
  ``tests/test_torch_models.py``; at bfloat16 also a layer whose output
  the new token's own score decides (the port merges that term in
  float32 inside the kernel's softmax, as the reference's
  ``_merge_self`` does).
* Both engines on a prefix-heavy scripted workload with a forced
  preemption (the ``drive()`` pattern of ``tests/test_torch_engine.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.core.paged_kv import PagedKVConfig as JKVConfig
from repro.core.paged_kv import PagedKVManager as JManager
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models.api import build_model as jbuild_model
from repro.models.lm import write_token_paged
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.models.lm import DecoderLM, layer_params
from test_torch_engine import assert_same, drive, make_pair

torch.set_num_threads(1)

F32_TOL, BF16_TOL = 3e-5, 3e-2
MODEL_TOL = 1e-4
_TORCH = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _both(arr, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(arr, np.float32)).astype(dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _attn_inputs(rng, B, KVH, G, HD, BT, MB, dtype, *, VD=None, NB=None,
                 lens=None, tables=None, latent=False):
    """(jax args, torch args) of one ``paged_attention`` call."""
    NB = NB or B * MB + 2
    q = _both(rng.standard_normal((B, KVH, G, HD)), dtype)
    kp = _both(rng.standard_normal((NB, BT, KVH, HD)), dtype)
    vp = kp if latent else _both(
        rng.standard_normal((NB, BT, KVH, VD or HD)), dtype)
    if tables is None:
        tables = rng.permutation(NB)[: B * MB].reshape(B, MB)
    if lens is None:
        lens = rng.integers(1, MB * BT + 1, B)
    tables = np.asarray(tables, np.int32)
    lens = np.asarray(lens, np.int32)
    jx = [q[0], kp[0], vp[0], jnp.asarray(tables), jnp.asarray(lens)]
    tx = [q[1], kp[1], vp[1], torch.from_numpy(tables),
          torch.from_numpy(lens)]
    return jx, tx


# ---------------------------------------------------------------------------
# kernel #7: paged_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,KVH,G,HD,BT,MB", [
    (2, 1, 8, 64, 16, 4),      # MQA
    (3, 2, 4, 128, 32, 3),     # GQA
    (1, 4, 1, 64, 8, 8),       # MHA-ish
    (2, 1, 40, 96, 16, 3),     # MLA's 40 heads on one latent head
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_paged_attention_matches_pallas_and_oracle(B, KVH, G, HD, BT, MB,
                                                   dtype):
    rng = np.random.default_rng(B * 100 + G)
    jx, tx = _attn_inputs(rng, B, KVH, G, HD, BT, MB, dtype)
    o = ref.paged_attention_ref(*tx)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(o, jops.paged_attention(*jx, interpret=True), tol)
    _close(o, jops.paged_attention_ref(*jx), tol)
    assert o.dtype == tx[0].dtype and o.shape == (B, KVH, G, HD)


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 40), (50.0, 24)])
def test_paged_attention_softcap_window(softcap, window):
    """Positive windows keep ``pos >= lens - window`` as the Pallas
    kernel does (None is global; the port reads window <= 0 as global
    too, where Pallas with 0 would mask every key)."""
    rng = np.random.default_rng(7)
    B, KVH, G, HD, BT, MB = 2, 2, 2, 64, 16, 5
    jx, tx = _attn_inputs(rng, B, KVH, G, HD, BT, MB, np.float32,
                          NB=B * MB, lens=[61, 33],
                          tables=np.arange(B * MB).reshape(B, MB))
    o = ref.paged_attention_ref(*tx, softcap=softcap, window=window)
    _close(o, jops.paged_attention(*jx, softcap=softcap, window=window,
                                   interpret=True), F32_TOL)
    _close(o, jops.paged_attention_ref(*jx, softcap=softcap, window=window),
           F32_TOL)
    if window is not None:
        assert torch.equal(ops.paged_attention(*tx, softcap=softcap,
                                               window=0),
                           ref.paged_attention_ref(*tx, softcap=softcap))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("G", [8, 40])
def test_paged_attention_mla_latent(dtype, G):
    """Latent mode: V is the first v_dim lanes of the SAME pool rows."""
    rng = np.random.default_rng(G)
    B, LAT, VD, BT, MB = 2, 96, 64, 16, 4
    jx, tx = _attn_inputs(rng, B, 1, G, LAT, BT, MB, dtype, NB=B * MB,
                          lens=[50, 17], latent=True)
    o = ref.paged_attention_ref(*tx, v_dim=VD)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _close(o, jops.paged_attention(*jx, v_dim=VD, interpret=True), tol)
    _close(o, jops.paged_attention_ref(*jx, v_dim=VD), tol)
    assert o.shape == (B, 1, G, VD)
    assert torch.equal(ops.paged_attention(*tx, v_dim=VD), o)


def test_paged_attention_null_entries_and_empty_row():
    """NULL (-1) table entries past a row's end clamp to block 0 and are
    masked; a zero-length row gives 0, as the reference's model path
    (``_paged_ref``) does -- the Pallas kernel gives the mean of the
    table's V rows there instead, so that row is left out of the
    Pallas comparison."""
    rng = np.random.default_rng(8)
    B, KVH, G, HD, BT, MB = 3, 1, 40, 64, 8, 4
    NB = B * MB
    tables = rng.permutation(NB).reshape(B, MB)
    tables[1, 2:] = -1
    tables[2, 1:] = -1
    jx, tx = _attn_inputs(rng, B, KVH, G, HD, BT, MB, np.float32, NB=NB,
                          lens=[MB * BT, 13, 0], tables=tables)
    o = ref.paged_attention_ref(*tx)
    po = jops.paged_attention(*jx, interpret=True)
    _close(o[:2], np.asarray(po)[:2], F32_TOL)
    assert not o[2].any()
    mo, ml, _ = JA._paged_ref(jx[0], jx[1], jx[2], jx[3], jx[4],
                              scale=HD ** -0.5, softcap=None, window=None)
    _close(o, mo, F32_TOL)
    assert float(np.asarray(ml)[2].max()) == 0.0


def test_paged_attention_float32_output():
    """bf16 inputs with ``out_dtype=float32`` (what absorbed MLA asks
    for): the output is the float32 value that the default rounds to
    bf16, and within 3e-2 of the reference model path's float32 output
    (``_paged_ref``, which also rounds the probabilities to bf16)."""
    rng = np.random.default_rng(10)
    B, LAT, VD, BT, MB = 2, 96, 64, 16, 4
    jx, tx = _attn_inputs(rng, B, 1, 40, LAT, BT, MB, jnp.bfloat16,
                          NB=B * MB, lens=[50, 17], latent=True)
    o32 = ref.paged_attention_ref(*tx, v_dim=VD, out_dtype=torch.float32)
    assert o32.dtype == torch.float32
    assert torch.equal(o32.to(torch.bfloat16),
                       ref.paged_attention_ref(*tx, v_dim=VD))
    assert torch.equal(ops.paged_attention(*tx, v_dim=VD,
                                           out_dtype=torch.float32), o32)
    mo, _, _ = JA._paged_ref(*jx, scale=LAT ** -0.5, softcap=None,
                             window=None, v_dim=VD)
    _close(o32, mo, BF16_TOL)
    with pytest.raises(TypeError):
        ops.paged_attention(*tx, v_dim=VD, out_dtype=torch.float16)


def test_paged_attention_wrapper_checks_shapes():
    rng = np.random.default_rng(9)
    _, tx = _attn_inputs(rng, 2, 1, 4, 32, 8, 2, np.float32, latent=True)
    with pytest.raises(ValueError):
        ops.paged_attention(tx[0], tx[1], tx[2][:, :4], *tx[3:])
    ops.reset_launch_counts()
    ops.paged_attention(*tx, v_dim=16)
    assert ops.launch_counts()["paged_attention"] == 0   # CPU: plain


# ---------------------------------------------------------------------------
# latent paged KV
# ---------------------------------------------------------------------------
def test_latent_kv_config_and_cache_match_reference():
    cfg = get_config("minicpm3_4b")
    tm, jm = DecoderLM(cfg), jbuild_model(jget_config("minicpm3_4b"))
    tkv, jkv = tm.kv_config(max_seq=384, num_blocks=12), \
        jm.kv_config(max_seq=384, num_blocks=12)
    assert tkv.latent and tkv.token_shape() == (288,) == jkv.token_shape()
    assert tkv.pool_shape() == jkv.pool_shape() == (62, 12, 64, 288)
    # one 64-token block over 62 layers: 62 * 64 * 288 * 2 B
    assert tkv.swap_nbytes_per_block() == jkv.swap_nbytes_per_block() \
        == 2_285_568
    small = dataclasses.replace(tkv, num_layers=2, num_blocks=6,
                                max_blocks_per_seq=2, block_tokens=4,
                                head_dim=12, dtype=torch.float32)
    jsmall = JKVConfig(num_layers=2, kv_heads=1, head_dim=12,
                       block_tokens=4, num_blocks=6, max_blocks_per_seq=2,
                       latent=True, dtype=jnp.float32)
    tc = PagedKVCache.create(small, 2, device="cpu")
    assert tc.v_pool is None and tuple(tc.k_pool.shape) == (2, 6, 4, 12)
    tables = np.array([[4, 1], [2, -1]], np.int32)
    tc.block_tables.copy_(torch.from_numpy(tables))
    lat = np.random.default_rng(3).standard_normal((2, 2, 8, 12))
    lens = np.array([7, 3], np.int32)
    tc = tc.write_prefill(torch.from_numpy(lat).float(), None,
                          torch.from_numpy(lens))
    jc = dataclasses.replace(JCache.create(jsmall, 2),
                             block_tables=jnp.asarray(tables))
    jc = jc.write_prefill(jnp.asarray(lat, jnp.float32), None,
                          jnp.asarray(lens))
    assert np.array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    assert np.array_equal(tc.seq_lens.numpy(), lens)
    with pytest.raises(ValueError):
        tc.write_prefill(torch.from_numpy(lat).float(),
                         torch.from_numpy(lat).float(),
                         torch.from_numpy(lens))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mla_pair():
    jcfg = jget_config("minicpm3_4b").reduced()
    cfg = get_config("minicpm3_4b").reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


def _tables(mgr_cls, kv, nseq, tokens):
    mgr = mgr_cls(kv)
    return np.stack([(mgr.admit(i, tokens), mgr.device_table(i))[1]
                     for i in range(nseq)])


def test_param_tree_matches_reference(mla_pair):
    """The port's own init builds the reference's tree (same keys and
    shapes), so ``convert_params`` maps one onto the other leaf by leaf
    with no change; the low-rank norms start at ones."""
    jm, jp, tm, tp, cfg = mla_pair
    mine = tm.init(seed=1, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [(jax.tree_util.keystr(k), tuple(np.shape(v))) for k, v in flat_j] \
        == [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in flat_t]
    assert torch.equal(mine["layers"]["attn"]["kv_a_norm"],
                       torch.ones_like(mine["layers"]["attn"]["kv_a_norm"]))
    assert torch.equal(mine["layers"]["attn"]["q_a_norm"],
                       torch.ones_like(mine["layers"]["attn"]["q_a_norm"]))
    for (_, jv), (_, tv) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree_util.tree_flatten_with_path(tp)[0]):
        assert np.array_equal(np.asarray(jv), tv.numpy())


def test_mla_decode_one_layer_matches_jax(mla_pair):
    """One layer's absorbed decode: y against the JAX ``mla_decode``
    (cached attention + separate self merge) and the pool against its
    ``write_token_paged``, rows of lengths 0, mid-block and block end,
    one with NULL entries past its end."""
    jm, jp, tm, tp, cfg = mla_pair
    rng = np.random.default_rng(11)
    B, BT, MB = 3, cfg.kv_block_tokens, 3
    LAT = cfg.mla.latent_dim
    NB = B * MB + 1
    pool = rng.standard_normal((NB, BT, LAT)).astype(np.float32)
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    tables[0, 1:] = -1
    lens = np.array([0, 13, 2 * BT - 1], np.int32)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda t: t[0], jp["layers"]["attn"])
    jy, jnew = JA.mla_decode(jlp, jnp.asarray(x), jget_config(
        "minicpm3_4b").reduced(), jnp.asarray(pool), jnp.asarray(tables),
        jnp.asarray(lens))
    jpool = write_token_paged(jnp.asarray(pool), jnew, jnp.asarray(tables),
                              jnp.asarray(lens), BT)
    tpool = torch.from_numpy(pool.copy())
    ty = A.mla_decode(layer_params(tp["layers"], 0)["attn"],
                      torch.from_numpy(x), cfg, tpool,
                      torch.from_numpy(tables), torch.from_numpy(lens))
    _close(ty, jy, MODEL_TOL)
    _close(tpool, jpool, F32_TOL)


def test_mla_decode_one_layer_bf16_matches_jax(mla_pair):
    """The same layer at bfloat16 (parameters, input and pool the bf16
    values of the reference's): y within 3e-2 of the JAX ``mla_decode``,
    the written pool rows within 3e-2 of ``write_token_paged``, and the
    port no less precise than the reference -- its largest error against
    the float32 JAX layer on the same values is at most 1.25x the
    reference's own bf16 error (the port attends in float32 and
    un-absorbs from a float32 attention output, as the reference does)."""
    jm, jp, tm, tp, cfg = mla_pair
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = jget_config("minicpm3_4b").reduced()
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    rng = np.random.default_rng(12)
    B, BT, MB = 3, cfg.kv_block_tokens, 3
    NB = B * MB + 1
    jlp = jax.tree.map(lambda t: t[0].astype(jnp.bfloat16),
                       jp["layers"]["attn"])
    jpool, tpool = _both(rng.standard_normal((NB, BT, cfg.mla.latent_dim)),
                         jnp.bfloat16)
    jx, tx = _both(rng.standard_normal((B, cfg.d_model)), jnp.bfloat16)
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    tables[0, 1:] = -1
    lens = np.array([0, 13, 2 * BT - 1], np.int32)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    jy, jnew = JA.mla_decode(jlp, jx, jcfg16, jpool, jt, jl)
    jy32, _ = JA.mla_decode(jax.tree.map(lambda t: t.astype(jnp.float32),
                                         jlp), jx.astype(jnp.float32), jcfg,
                            jpool.astype(jnp.float32), jt, jl)
    jpool = write_token_paged(jpool, jnew, jt, jl, BT)
    tlp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
           for k, v in jlp.items()}
    ty = A.mla_decode(tlp, tx, cfg16, tpool, torch.from_numpy(tables),
                      torch.from_numpy(lens))
    assert ty.dtype == torch.bfloat16 and tpool.dtype == torch.bfloat16
    _close(ty, jy, BF16_TOL)
    _close(tpool, jpool, BF16_TOL)
    exact = _np(jy32)
    assert np.abs(_np(ty) - exact).max() \
        <= 1.25 * np.abs(_np(jy) - exact).max()


def test_mla_decode_bf16_self_term_decides_output(mla_pair):
    """bf16 layer whose output turns on the new token's own score.  Each
    row has one cached key, the new token's latent plus a large offset in
    its V lanes orthogonal to every head's ``q_lat``: its score ties with
    the new token's, their values differ, and ``wq_b`` scaled 256x gives
    scores of ~140, so a score rounded to bf16 (an error of ~0.3) moves
    the softmax weights.  The reference scores the new token with
    ``q_eff * scale`` in float32 (``_merge_self``) and the cached keys
    with it rounded to bf16 (``_paged_ref``); the port must do the same
    (scoring the new token with the rounded operand gave 0.17 here)."""
    jm, jp, tm, tp, cfg = mla_pair
    m, H = cfg.mla, cfg.num_heads
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg16 = dataclasses.replace(jget_config("minicpm3_4b").reduced(),
                                 dtype="bfloat16")
    rng = np.random.default_rng(21)
    B, BT, MB = 3, cfg.kv_block_tokens, 2
    NB = B * MB + 1
    jlp = {k: v[0].astype(jnp.bfloat16)
           for k, v in jp["layers"]["attn"].items()}
    jlp["wq_b"] = (jp["layers"]["attn"]["wq_b"][0] * 256).astype(jnp.bfloat16)
    jx, tx = _both(rng.standard_normal((B, cfg.d_model)), jnp.bfloat16)
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.ones(B, np.int32)
    pos = jnp.asarray(lens)[:, None]
    q_nope, _ = JA._mla_q(jlp, jx[:, None], jcfg16, pos)
    wk_b = jlp["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = np.asarray(jnp.einsum("bhd,lhd->bhl",
                                  q_nope[:, 0].astype(jnp.float32),
                                  wk_b.astype(jnp.float32)))
    c_new, k_rope = JA._mla_latent(jlp, jx[:, None], jcfg16, pos)
    lat = np.asarray(jnp.concatenate([c_new, k_rope], -1)[:, 0], np.float32)
    pool = rng.standard_normal((NB, BT, m.latent_dim))
    for b in range(B):
        null = np.linalg.svd(q_lat[b])[2][H:].T     # (kv_lora, kv_lora - H)
        row = lat[b].copy()
        row[: m.kv_lora_rank] += 2 * null @ rng.standard_normal(null.shape[1])
        pool[tables[b, 0], 0] = row
    jpool, tpool = _both(pool, jnp.bfloat16)
    jy, jnew = JA.mla_decode(jlp, jx, jcfg16, jpool, jnp.asarray(tables),
                             jnp.asarray(lens))
    jpool = write_token_paged(jpool, jnew, jnp.asarray(tables),
                              jnp.asarray(lens), BT)
    tlp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
           for k, v in jlp.items()}
    ty = A.mla_decode(tlp, tx, cfg16, tpool, torch.from_numpy(tables),
                      torch.from_numpy(lens))
    _close(ty, jy, BF16_TOL)
    _close(tpool, jpool, BF16_TOL)


def test_write_latent_token_drops_write_on_full_table():
    pool = torch.zeros(4, 2, 3)
    tables = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    lens = torch.tensor([4, 1], dtype=torch.int32)     # row 0: full table
    ref.write_tail_rows(pool, torch.ones(2, 3), tables, lens)
    want = torch.zeros(4, 2, 3)
    want[3, 1] = 1.0
    assert torch.equal(pool, want)


def test_forward_logits_match(mla_pair):
    jm, jp, tm, tp, cfg = mla_pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl = tm.forward(tp, torch.as_tensor(toks))
    _close(tl, jl, MODEL_TOL)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


def test_prefill_then_decode_logits_match_every_step(mla_pair):
    """Prefill 16 tokens, then decode_step 8 more: the logits of every
    step, the greedy tokens and the latent pool match the JAX model's
    prefill + decode_step, and every step's logits match the JAX full
    forward at that position."""
    jm, jp, tm, tp, cfg = mla_pair
    B, S, S0 = 2, 24, 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jfull, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    jkv, tkv = jm.kv_config(max_seq=S, batch=B), tm.kv_config(max_seq=S,
                                                               batch=B)
    tb = _tables(JManager, jkv, B, S)
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tb))
    tc = PagedKVCache.create(tkv, B, device="cpu")
    assert tc.v_pool is None
    tc.block_tables.copy_(torch.as_tensor(tb))
    lens = np.full(B, S0, np.int32)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, jc,
                           jnp.asarray(lens))
    tlast, tc = tm.prefill(tp, torch.as_tensor(toks[:, :S0]), tc,
                           torch.as_tensor(lens))
    _close(tlast, jlast, MODEL_TOL)
    for t in range(S0, S):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc)
        tl, tc = tm.decode_step(tp, torch.as_tensor(toks[:, t]), tc)
        _close(tl, jl, MODEL_TOL)
        _close(tl, jfull[:, t], MODEL_TOL)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jl.argmax(-1))), t
    assert np.array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    _close(tc.k_pool, jc.k_pool, MODEL_TOL)


def test_greedy_decode_tokens_match(mla_pair):
    """Greedy generation through ``decode_fused``: identical tokens."""
    jm, jp, tm, tp, cfg = mla_pair
    B, S0, steps = 2, 8, 10
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S0))
    max_seq = S0 + steps + 1
    jkv, tkv = jm.kv_config(max_seq=max_seq, batch=B), \
        tm.kv_config(max_seq=max_seq, batch=B)
    tb = _tables(PagedKVManager, tkv, B, max_seq)
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tb))
    tc = PagedKVCache.create(tkv, B, device="cpu")
    tc.block_tables.copy_(torch.as_tensor(tb))
    lens = np.full(B, S0, np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jc,
                        jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.as_tensor(prompt), tc,
                        torch.as_tensor(lens))
    jt, tt = jnp.argmax(jl, -1), tl.argmax(-1)
    empty = np.zeros(0, np.int32)
    jout, tout = [], []
    for _ in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        jout.append(np.asarray(jt))
        tout.append(tt.numpy())
        jt, jc = jm.decode_fused(jp, jt, jc, jnp.asarray(empty),
                                 jnp.zeros((0, jkv.max_blocks_per_seq),
                                           jnp.int32), jnp.asarray(empty))
        tt, tc = tm.decode_fused(tp, tt, tc, torch.as_tensor(empty),
                                 torch.zeros((0, tkv.max_blocks_per_seq),
                                             dtype=torch.int32),
                                 torch.as_tensor(empty))
    assert np.array_equal(np.stack(jout), np.stack(tout))


def test_plain_path_equals_kernel_path_on_cpu(mla_pair):
    """``plain=True`` runs the same functions (CPU tensors take the plain
    versions either way): identical logits, no kernel launch."""
    jm, jp, tm, tp, cfg = mla_pair
    plain = build_model(cfg, plain=True)
    B, S = 2, 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    tkv = tm.kv_config(max_seq=S + 8, batch=B)
    tb = torch.as_tensor(_tables(PagedKVManager, tkv, B, S + 8))
    outs = []
    ops.reset_launch_counts()
    for model in (tm, plain):
        c = PagedKVCache.create(tkv, B, device="cpu")
        c.block_tables.copy_(tb)
        _, c = model.prefill(tp, torch.as_tensor(toks), c,
                             torch.full((B,), S, dtype=torch.int32))
        lg, c = model.decode_step(tp, torch.as_tensor(toks[:, -1]), c)
        outs.append(lg)
    assert torch.equal(outs[0], outs[1])
    assert all(v == 0 for v in ops.launch_counts().values())


def test_decoder_refuses_unported_mla_modes():
    """MLA has no suffix prefill, as in the reference.  The split-latent
    pool (``mla_latent_tp``), once refused here, builds: its pool keeps
    the lora and rope streams apart (its numbers are held in
    ``tests/test_torch_latent_tp.py``)."""
    cfg = get_config("minicpm3_4b").reduced()
    assert not DecoderLM(cfg).supports_suffix_prefill
    split = DecoderLM(dataclasses.replace(cfg, mla_latent_tp=True))
    kv = split.kv_config(max_seq=32, batch=2)
    assert (kv.head_dim, kv.latent_rope) == (cfg.mla.kv_lora_rank,
                                             cfg.mla.qk_rope_head_dim)
    assert not split.supports_suffix_prefill
    # MoE is served since deepseek-v2-lite (MLA + MoE) and the image
    # prefix since internvl2-1b: a model with image tokens builds, and its
    # prompt needs the image embeddings
    vlm = DecoderLM(dataclasses.replace(cfg, num_image_tokens=8))
    with pytest.raises(ValueError, match="image_embeds"):
        vlm.forward(vlm.init(0, device="cpu"),
                    torch.zeros((1, 8), dtype=torch.int64))
    assert DecoderLM(get_config("deepseek_v2_lite_16b").reduced()).is_moe
    with pytest.raises(NotImplementedError):
        DecoderLM(cfg).prefill_suffix(None, None, None, None, None, None)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_pair():
    return make_pair("minicpm3_4b")


def test_prefix_heavy_workload_with_preemption_matches_jax(engine_pair):
    """Shared prompts (one of them an exact prefix ending mid-block, so
    the first divergent write fulfils a COW copy) and a forced LIFO
    preemption with swap-out and swap-in of whole latent blocks: both
    engines agree on tokens, preemptions, the per-step swap ledger,
    prefix hits, ``prefill_tokens_saved`` (0: MLA recomputes the whole
    prompt of a forked child), COW copies, compactions and steps."""
    cfg = engine_pair[4]
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, size=12)
    reqs = [(base, 10), (rng.randint(2, cfg.vocab_size, size=9), 6),
            (base, 6),
            (np.concatenate([base, rng.randint(2, cfg.vocab_size, size=6)]),
             6),
            (rng.randint(2, cfg.vocab_size, size=5), 6)]

    def hook(eng, state):
        if eng.steps == 3 and eng.running and not state.get("forced"):
            eng.preempt_latest()
            state["forced"] = True

    j, t = (drive(pkg, engine_pair, reqs,
                  dict(slots=3, max_seq=64, num_blocks=20, watermark=1),
                  hook=hook) for pkg in ("jax", "torch"))
    assert_same(j, t)
    eng = t["engine"]
    assert not eng.suffix_prefill and eng.mgr.config.latent
    assert len(t["tokens"]) == 5 and t["state"]["forced"]
    assert t["preemptions"] >= 1 and t["prefix_hits"] >= 2
    assert t["prefill_tokens_saved"] == 0 and t["cow_copies"] >= 1
    block = eng.mgr.config.swap_nbytes_per_block()
    outs, ins, out_b, in_b = t["ledger"][-1]
    assert outs >= 1 and ins >= 1 and out_b == in_b and out_b % block == 0


def test_serve_launcher_runs_minicpm3_on_cpu(capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", "minicpm3_4b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--trace",
                 "prefixheavy", "--prefill-budget", "none"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "served 3/3 requests on cpu" in capsys.readouterr().out
