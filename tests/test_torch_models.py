"""The PyTorch DecoderLM against the JAX DecoderLM on reduced configs.

Parameters come from the JAX ``init`` and are converted through numpy
(``repro_torch.models.convert``); the token inputs are drawn with a
seeded numpy generator and handed to both packages.  Both run float32
on the CPU, so the logits agree to float32 rounding of differently
ordered sums: ATOL = RTOL = 1e-4 (observed differences are ~1e-6), and
greedy tokens must be identical.  Covered: ``forward``, ``prefill``,
``decode_step`` / ``decode_fused`` (the fused append-then-attend path
against the reference's write + attend + merge) and ``prefill_suffix``
(suffix prefill through COW-shared prefix blocks; GQA only).
``gemma2_27b`` reduced adds sliding windows, softcaps and post-norms;
``gemma3_27b`` 5:1 local/global windows, dual rope theta and qk-norm;
``qwen3_moe_30b_a3b`` the MoE feed-forward with qk-norm;
``deepseek_v2_lite_16b`` MLA's latent pool with MoE, shared experts and
a leading dense layer.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.core.paged_kv import PagedKVManager as JManager
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, S, S0 = 2, 24, 16


def _pair(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


GQA_ARCHS = ["gemma_2b", "gemma2_27b", "gemma3_27b", "qwen3_moe_30b_a3b"]


@pytest.fixture(scope="module", params=GQA_ARCHS + ["deepseek_v2_lite_16b"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=GQA_ARCHS)
def gqa_pair(request):
    """The archs with suffix prefill (MLA recomputes a forked prompt)."""
    return _pair(request.param)


def _tables(mgr_cls, cfg_kv, nseq, tokens):
    mgr = mgr_cls(cfg_kv)
    return mgr, np.stack([(mgr.admit(i, tokens), mgr.device_table(i))[1]
                          for i in range(nseq)])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


def test_forward_logits_match(pair):
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl = tm.forward(tp, torch.as_tensor(toks))
    _close(tl.numpy(), jl)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


def test_prefill_then_decode_fused_match(pair):
    """Prefill S0 tokens, then decode the rest through ``decode_fused``
    with the table delta on the first step: logits of every step and the
    greedy tokens match the JAX model's prefill + decode_fused, and the
    pools end identical."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jkv = jm.kv_config(max_seq=S, batch=B)
    tkv = tm.kv_config(max_seq=S, batch=B)
    _, tb = _tables(JManager, jkv, B, S)
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tb))
    tc = PagedKVCache.create(tkv, B, device="cpu")
    tc.block_tables.copy_(torch.as_tensor(tb))
    lens = np.full(B, S0, np.int32)
    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, jc,
                           jnp.asarray(lens))
    tlast, tc = tm.prefill(tp, torch.as_tensor(toks[:, :S0]), tc,
                           torch.as_tensor(lens))
    _close(tlast.numpy(), jlast)
    empty = np.zeros(0, np.int32)
    for t in range(S0, S):
        jn, jc = jm.decode_fused(jp, jnp.asarray(toks[:, t]), jc,
                                 jnp.asarray(empty),
                                 jnp.zeros((0, jkv.max_blocks_per_seq),
                                           jnp.int32), jnp.asarray(empty))
        tn, tc = tm.decode_fused(tp, torch.as_tensor(toks[:, t]), tc,
                                 torch.as_tensor(empty),
                                 torch.zeros((0, tkv.max_blocks_per_seq),
                                             dtype=torch.int32),
                                 torch.as_tensor(empty))
        assert np.array_equal(tn.numpy(), np.asarray(jn)), t
    assert np.array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    _close(tc.k_pool.numpy(), jc.k_pool)
    assert (tc.v_pool is None) == (jc.v_pool is None)   # MLA: latent only
    if tc.v_pool is not None:
        _close(tc.v_pool.numpy(), jc.v_pool)


def test_decode_step_logits_match_forward_logits(pair):
    """decode_step through the fused append kernel's plain version
    reproduces the JAX full-forward logits position by position."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    jl, _, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tkv = tm.kv_config(max_seq=S, batch=B)
    _, tb = _tables(PagedKVManager, tkv, B, S)
    tc = PagedKVCache.create(tkv, B, device="cpu")
    tc.block_tables.copy_(torch.as_tensor(tb))
    _, tc = tm.prefill(tp, torch.as_tensor(toks[:, :S0]), tc,
                       torch.full((B,), S0, dtype=torch.int32))
    for t in range(S0, S):
        lg, tc = tm.decode_step(tp, torch.as_tensor(toks[:, t]), tc)
        _close(lg.numpy(), jl[:, t])


def test_prefill_suffix_matches(gqa_pair):
    """Row 0 prefills 16 tokens; row 1 (a fork) aliases its first two
    blocks and suffix-prefills 12 more through the table.  Last logits,
    greedy tokens and the pools match the JAX model's prefill_suffix."""
    jm, jp, tm, tp, cfg = gqa_pair
    bt = cfg.kv_block_tokens
    rng = np.random.default_rng(4)
    base = rng.integers(0, cfg.vocab_size, 16)
    child = np.concatenate([base, rng.integers(0, cfg.vocab_size, 12)])
    max_seq = 32
    results = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            kv = jm.kv_config(max_seq=max_seq, batch=2, num_blocks=12)
            mgr = JManager(kv)
        else:
            kv = tm.kv_config(max_seq=max_seq, batch=2, num_blocks=12)
            mgr = PagedKVManager(kv)
        mgr.admit(0, 16)
        mgr.fork(0, 1, 16)
        mgr.extend(1, len(child))
        sink = mgr.reserve_block()
        t0 = mgr.device_table(0)
        t1 = mgr.device_table(1)
        tables = np.full((1, kv.max_blocks_per_seq), sink, np.int32)
        keep = t0 != -1
        tables[0, keep] = t0[keep]
        ctable = np.where(t1 != -1, t1, sink)[None].astype(np.int32)
        # suffix of the child: positions 16..27, one padded 16-token span
        stoks = np.zeros((1, 2 * bt), np.int64)
        stoks[0, :12] = child[16:]
        wt = np.asarray([[t1[2], t1[3]]], np.int32)
        if pkg == "jax":
            c = dataclasses.replace(JCache.create(kv, 1),
                                    block_tables=jnp.asarray(tables))
            _, c = jm.prefill(jp, {"tokens": jnp.asarray(
                base[None].astype(np.int32))}, c, jnp.asarray([16]))
            c = dataclasses.replace(c, block_tables=jnp.asarray(ctable))
            last, c = jm.prefill_suffix(
                jp, jnp.asarray(stoks), c, jnp.asarray([len(child)]),
                jnp.asarray([16]), jnp.asarray(wt))
            results[pkg] = (np.asarray(last), np.asarray(c.k_pool),
                            np.asarray(c.v_pool))
        else:
            c = PagedKVCache.create(kv, 1, device="cpu")
            c.block_tables.copy_(torch.as_tensor(tables))
            _, c = tm.prefill(tp, torch.as_tensor(base[None]), c,
                              torch.as_tensor([16], dtype=torch.int32))
            c = dataclasses.replace(c, block_tables=torch.as_tensor(ctable))
            last, c = tm.prefill_suffix(
                tp, torch.as_tensor(stoks), c,
                torch.as_tensor([len(child)], dtype=torch.int32),
                torch.as_tensor([16], dtype=torch.int32),
                torch.as_tensor(wt))
            results[pkg] = (last.numpy(), c.k_pool.numpy(), c.v_pool.numpy())
    jl, jk, jv = results["jax"]
    tl, tk, tv = results["torch"]
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1), jl.argmax(-1))
    _close(tk, jk)
    _close(tv, jv)


def test_convert_roundtrips_bfloat16_exactly():
    """bf16 leaves convert losslessly (through float32)."""
    cfg = get_config("gemma_2b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    leaf = np.asarray(jnp.asarray(
        np.random.default_rng(5).standard_normal((4, 8)), jnp.bfloat16))
    out = convert_params({"w": leaf}, cfg, device="cpu")["w"]
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.float().numpy(), leaf.astype(np.float32))
