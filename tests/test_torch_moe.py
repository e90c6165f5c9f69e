"""The port's MoE feed-forward and qk-norm against the JAX package.

* ``init_moe``'s tree, ``route`` and ``moe_ffn`` against
  ``repro.models.moe`` on reduced ``qwen3_moe_30b_a3b`` and
  ``deepseek_v2_lite_16b`` (shared experts), with the reference's
  parameters converted through numpy: float32 to 1e-5, identical routed
  expert ids, at decode sizes (T * k <= E: each replica gathers its
  expert) and prefill sizes (the expert-sorted block layout).
* In bfloat16 (the combine adds each token's weighted expert outputs in
  the activation dtype, as the reference's ``.at[].add`` does) within
  the port's bf16 tolerance, ``BF16_TOL``.
* The two layouts compute the same function; every shape of
  ``moe_ffn`` follows from T, k and E (it runs on the ``meta`` device,
  where no op can read the routing), so a decode step never waits for
  the host.
* ``convert_params`` keeps the router float32 in a bfloat16 config.
* ``head_rmsnorm`` and the qk-norm ``_gqa_qkv`` against the reference's.
* The port's own ``init`` fills the stacked layers one by one and builds
  the reference's tree, leading dense layers included; the full-width
  configs are the published shapes; the launcher serves each new arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import moe as JMOE
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.api import build_model
from repro_torch.models.common import head_rmsnorm
from repro_torch.models.convert import convert_params

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2                  # |port - ref| <= tol + tol * |ref|
MOE_ARCHS = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _moe_params(arch, dtype="float32", seed=0):
    """(cfg, JAX moe params, the port's converted params)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jp, _ = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _x(T, d, seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_tree_matches_reference(arch):
    """Same keys and shapes; the router is float32 in both, in bf16 too."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg, jp, _ = _moe_params(arch, dtype)
        g = torch.Generator().manual_seed(0)
        mine = MOE.init_moe(g, cfg, torch.device("cpu"))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in mine.items()}
        assert mine["router"].dtype == torch.float32
        assert ("shared_wi" in mine) == bool(cfg.moe.num_shared_experts)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T", [1, 4, 37])
def test_route_matches_reference(arch, T):
    jcfg, cfg, jp, tp = _moe_params(arch)
    jx, tx = _x(T, cfg.d_model, 10 + T)
    jw, je, jaux = JMOE.route(jp["router"], jx, jcfg.moe)
    tw, te, tprobs = MOE.route(tp["router"], tx, cfg.moe)
    taux = MOE.load_balance_loss(tprobs, te, cfg.moe)
    assert np.array_equal(te.numpy(), np.asarray(je))
    _close(tw, jw, F32_TOL)
    _close(taux, jaux, F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T", [1, 3, 4, 5, 37, 96])
def test_moe_ffn_matches_reference(arch, T):
    """T * k <= E (8 experts, top 2: T <= 4) takes the replica layout,
    larger T the blocked one; both equal the reference within 1e-5."""
    jcfg, cfg, jp, tp = _moe_params(arch)
    jx, tx = _x(T, cfg.d_model, 20 + T)
    jy, jaux = JMOE.moe_ffn(jp, jx, jcfg)
    ty = MOE.moe_ffn(tp, tx, cfg)
    assert ty.shape == (T, cfg.d_model) and ty.dtype == torch.float32
    _close(ty, jy, F32_TOL)
    _, te, tprobs = MOE.route(tp["router"], tx, cfg.moe)
    _close(MOE.load_balance_loss(tprobs, te, cfg.moe), jaux, F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T", [4, 37])
def test_moe_ffn_bfloat16_within_tolerance(arch, T):
    """bfloat16 weights and activations: the expert matmuls and the
    combine round to bf16 as the reference's do (the router stays
    float32 and routes identically); the output is within BF16_TOL of
    the reference's and no farther from the float32 result."""
    jcfg, cfg, jp, tp = _moe_params(arch, "bfloat16")
    jx, tx = _x(T, cfg.d_model, 30 + T, jnp.bfloat16)
    tx = tx.to(torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["wi"].dtype == torch.bfloat16
    _, je, _ = JMOE.route(jp["router"], jx, jcfg.moe)
    _, te, _ = MOE.route(tp["router"], tx, cfg.moe)
    assert np.array_equal(te.numpy(), np.asarray(je))
    jy, _ = JMOE.moe_ffn(jp, jx, jcfg)
    ty = MOE.moe_ffn(tp, tx, cfg)
    assert ty.dtype == torch.bfloat16
    jy32 = np.asarray(jy.astype(jnp.float32))
    _close(ty.float(), jy32, BF16_TOL)
    # the float32 function on the same (bf16-valued) inputs
    tp32 = {k: v.float() for k, v in tp.items()}
    y32 = MOE.moe_ffn(tp32, tx.float(), dataclasses.replace(
        cfg, dtype="float32"))
    port_err = float((ty.float() - y32).abs().max())
    ref_err = float(np.abs(jy32 - y32.numpy()).max())
    assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


@pytest.mark.parametrize("R,E", [(1, 8), (17, 8), (64, 8), (300, 128),
                                 (512, 128)])
def test_blocked_layout_equals_replica_layout(R, E):
    """The prefill layout and the decode layout give the same outputs in
    the same (canonical) order, with empty experts, at any R; the block
    is the mean replicas per expert rounded up to 8."""
    rng = np.random.default_rng(R + E)
    d, f = 16, 24
    p = {k: torch.from_numpy((rng.standard_normal(s) * s[1] ** -0.5)
                             .astype(np.float32))
         for k, s in (("wi", (E, d, f)), ("wg", (E, d, f)),
                      ("wo", (E, f, d)))}
    xr = torch.from_numpy(rng.standard_normal((R, d)).astype(np.float32))
    expert = torch.from_numpy(rng.integers(0, E // 2, R))  # half stay empty
    a = MOE._swiglu_replicas(p, xr, expert)
    b = MOE._swiglu_blocked(p, xr, expert)
    _close(b, a, 1e-5)
    m = MOE.block_rows(R, E)
    assert m % 8 == 0 and m >= R / E and m <= MOE.MAX_BLOCK


def test_moe_ffn_shapes_follow_from_T_k_E_only():
    """On the meta device no op can read a value: a shape that depended
    on the routing (``nonzero``, ``unique``, ``bincount``, ``.item()``)
    would raise.  Both layouts run there and give (T, d)."""
    cfg = get_config("deepseek_v2_lite_16b").reduced()
    meta = torch.device("meta")
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg,
                     torch.device("cpu"))
    p = {k: v.to(meta) for k, v in p.items()}
    for T in (3, 40):                       # replica, then blocked layout
        x = torch.empty(T, cfg.d_model, device=meta)
        y = MOE.moe_ffn(p, x, cfg)
        assert y.shape == (T, cfg.d_model) and y.device.type == "meta"
        _, experts, probs = MOE.route(p["router"], x, cfg.moe)
        assert MOE.load_balance_loss(probs, experts, cfg.moe).shape == ()


def test_convert_keeps_router_float32_in_bf16_config():
    cfg = dataclasses.replace(get_config("qwen3_moe_30b_a3b").reduced(),
                              dtype="bfloat16")
    jm = jbuild_model(dataclasses.replace(
        jget_config("qwen3_moe_30b_a3b").reduced(), dtype="bfloat16"))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    assert jp["layers"]["ff"]["router"].dtype == jnp.float32
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tp["layers"]["ff"]["router"].dtype == torch.float32
    assert tp["layers"]["ff"]["wi"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["q_norm"].dtype == torch.bfloat16
    assert np.array_equal(tp["layers"]["ff"]["router"].numpy(),
                          np.asarray(jp["layers"]["ff"]["router"]))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_head_rmsnorm_matches_reference(dtype):
    """``w * x`` in float32 (not gemma-style), cast back to x's dtype."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 32)), dtype)
    w = jnp.asarray(1 + 0.1 * rng.standard_normal(32), dtype)
    want = JC.head_rmsnorm(x, w, 1e-6).astype(jnp.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = head_rmsnorm(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt), 1e-6)
    assert got.dtype == tdt
    _close(got.float(), want, F32_TOL if tdt == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "gemma3_27b"])
def test_qk_norm_gqa_qkv_matches_reference(arch):
    """q and k are normed per head after the projections and before
    rope (with the layer's theta), v is not; norm weights away from one
    so the norm's weight is exercised."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.qk_norm
    jp, _ = JA.init_gqa(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(8)
    jp["q_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(cfg.hd),
                               jnp.float32)
    jp["k_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(cfg.hd),
                               jnp.float32)
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(3, 9)[None].repeat(2, 0)
    for theta in (None, 10000.0):
        jq, jk, jv = JA._gqa_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 theta)
        tq, tk, tv = A._gqa_qkv(tp, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos), theta)
        for a, b in ((tq, jq), (tk, jk), (tv, jv)):
            _close(a, b, F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_init_fills_each_layer_and_matches_reference_tree(arch):
    jm = jbuild_model(jget_config(arch).reduced())
    jshapes, _ = jm.param_specs()
    cfg = get_config(arch).reduced()
    tm = build_model(cfg)
    mine = tm.init(seed=2, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in flat_j] \
        == [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in flat_t]
    wi = mine["layers"]["ff"]["wi"]
    assert all(not torch.equal(wi[i], wi[i + 1])
               for i in range(wi.shape[0] - 1))
    assert (tm.n_dense, tm.n_scan) == (jm.n_dense, jm.n_scan)
    if tm.n_dense:
        assert mine["dense_layers"]["ff"]["wi"].shape == (
            tm.n_dense, cfg.d_model, cfg.d_ff)
        assert [i for i, _ in tm.iter_layers(mine)] == list(range(
            cfg.num_layers))


def test_full_width_moe_configs_are_the_published_shapes():
    q = get_config("qwen3_moe_30b_a3b")
    assert (q.num_layers, q.d_model, q.num_heads, q.kv_heads, q.hd,
            q.vocab_size, q.qk_norm, q.tie_embeddings, q.dtype) \
        == (48, 2048, 32, 4, 128, 151936, True, False, "bfloat16")
    assert (q.moe.num_experts, q.moe.top_k, q.moe.d_ff_expert,
            q.moe.num_shared_experts, q.moe.first_dense_layers) \
        == (128, 8, 768, 0, 0)
    assert round(q.param_count() / 1e9, 1) == 30.5
    ds = get_config("deepseek_v2_lite_16b")
    m = ds.mla
    assert (ds.num_layers, ds.d_model, ds.num_heads, ds.d_ff,
            ds.vocab_size, ds.attention, m.q_lora_rank, m.kv_lora_rank,
            m.qk_rope_head_dim, m.qk_nope_head_dim, m.v_head_dim,
            m.latent_dim) \
        == (27, 2048, 16, 10944, 102400, "mla", None, 512, 64, 128, 128,
            576)
    assert (ds.moe.num_experts, ds.moe.top_k, ds.moe.d_ff_expert,
            ds.moe.num_shared_experts, ds.moe.d_ff_shared,
            ds.moe.first_dense_layers) == (64, 6, 1408, 2, 2816, 1)
    assert round(ds.param_count() / 1e9, 1) == 15.7
    g3 = get_config("gemma3_27b")
    assert (g3.num_layers, g3.d_model, g3.num_heads, g3.kv_heads, g3.hd,
            g3.local_window, g3.local_ratio, g3.qk_norm, g3.rope_theta,
            g3.rope_theta_local) \
        == (62, 5376, 32, 16, 128, 1024, 5, True, 1e6, 1e4)
    assert [g3.layer_is_local(i) for i in range(6)] == [True] * 5 + [False]


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
                                  "gemma3_27b"])
def test_serve_launcher_runs_new_arch_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--trace",
                 "prefixheavy", "--prefill-budget", "none"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "served 3/3 requests on cpu" in capsys.readouterr().out


def test_build_model_refuses_unported_families():
    # every family of the reference's build_model has a model here since
    # the audio and vision slice (tests/test_torch_whisper.py and
    # tests/test_torch_vlm.py build them); a family with no model at all
    # still raises
    for family in ("vision-encoder", "diffusion"):
        cfg = dataclasses.replace(get_config("gemma_2b"), family=family)
        with pytest.raises(NotImplementedError, match="no model"):
            build_model(cfg)
    for arch in ("whisper_tiny", "internvl2_1b"):
        assert jget_config(arch).family == get_config(arch).family
        build_model(get_config(arch))
