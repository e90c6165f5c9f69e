"""The MoE feed-forward over the model axis against the JAX package's
``shard_map`` layouts.

Ranks are threads of this process over gloo (``run_ranks``).  One MoE
layer of reduced ``qwen3_moe_30b_a3b`` (8 experts, top 2) and
``deepseek_v2_lite_16b`` (with shared experts), float32, the reference's
parameters converted through numpy; each rank holds the pieces that
``launch.steps.param_placements`` gives the layer's leaves.  The
reference runs on a ``jax.make_mesh((1, 1), ("data", "model"))`` of the
one CPU device, once per data shard on that shard's rows -- the port's
ranks of a shard hold the same rows, and the reference's layouts route
and slot each shard's tokens on their own:

* ``tp``: ``moe_ffn_dispatch`` on each rank's slice of the expert and
  shared hidden dims within 1e-5 of ``_moe_tp_shardmap``, the routed
  and shared partial outputs summed in one all-reduce;
* ``ep``: each rank's ``E / ep`` experts with the all-to-all exchange
  (``moe_ep``) and the one-device ``moe_ep_local`` within 1e-5 of
  ``_moe_ep_shardmap``, at capacity factor 0.5, which drops replicas
  (the count is asserted > 0), at the default 0 (1.25), and at 8, which
  drops none and then also equals the dropless ``moe_ffn``.

In bfloat16, ``tp``'s ranks sum float32 partial outputs and round once:
the result is the whole layer's float32 output rounded once, but for
float32 summation order (at most 1% of the elements a bf16 step off).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as JMOE
from repro.models import moe_sharded as JMS
from repro_torch.configs.base import get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe as MOE
from repro_torch.models import moe_sharded as MS
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params

torch.set_num_threads(1)

TOL = 1e-5                       # of max |y|
B, S = 4, 8                      # global rows, tokens a row
ARCHS = ["qwen3_moe_30b_a3b", "deepseek_v2_lite_16b"]
MESHES = [(1, 2), (1, 4), (2, 2)]


def _layer(arch, mode, cap):
    """(reference cfg, port cfg, reference params, port params) of one
    MoE layer."""
    def setup(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, parallel_mode=mode, capacity_factor=cap))
    jcfg = setup(jget_config(arch).reduced())
    cfg = setup(get_config(arch).reduced())
    jp, _ = JMOE.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _x(d):
    return np.random.default_rng(5).standard_normal((B, S, d)).astype(
        np.float32)


def _reference(fn, jp, x, jcfg, dp):
    """The reference layout on a (1, 1) mesh, run per data shard (under
    ``jax.jit``: its shard_map op by op takes seconds a call)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run = jax.jit(fn, static_argnums=(2, 3))
    rows = B // dp
    out = [np.asarray(run(jp, jnp.asarray(x[g * rows:(g + 1) * rows]), jcfg,
                          mesh)[0]) for g in range(dp)]
    return np.concatenate(out)


def _pieces(mesh, cfg, tp):
    """This rank's pieces of the layer under the model's placements
    (the stacked leaves' layer dim dropped)."""
    spec = STEPS.param_placements(build_model(cfg), mesh)["layers"]["ff"]
    return {k: SH.local_piece(mesh, v, spec[k][1:]) for k, v in tp.items()}


def _port(cfg, tp, x, shape):
    def fn(mesh):
        lp = _pieces(mesh, cfg, tp)
        rows = STEPS.shard_batch(mesh, {"x": x})["x"]
        with SH.use_rules(mesh), torch.no_grad():
            y = MS.moe_ffn_dispatch(lp, torch.as_tensor(rows), cfg)
        return y.numpy(), dict(mesh.stats.calls)

    out = run_ranks(shape, fn, device="cpu")
    dp, tpn = shape
    ys = [out[g * tpn][0] for g in range(dp)]
    for g in range(dp):              # a shard's model ranks agree
        for r in range(1, tpn):
            np.testing.assert_array_equal(out[g * tpn + r][0], ys[g])
    return np.concatenate(ys), out[0][1]


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_layout_matches_moe_tp_shardmap(arch, shape):
    jcfg, cfg, jp, tp = _layer(arch, "tp", 0.0)
    x = _x(cfg.d_model)
    got, calls = _port(cfg, tp, x, shape)
    _close(got, _reference(JMS._moe_tp_shardmap, jp, x, jcfg, shape[0]))
    # the routed and the shared experts' partial outputs: one sum
    assert calls["all_reduce"] == 1


@pytest.mark.parametrize("cap", [0.5, 0.0, 8.0])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_layout_matches_moe_ep_shardmap(arch, shape, cap):
    jcfg, cfg, jp, tp = _layer(arch, "ep", cap)
    x = _x(cfg.d_model)
    want = _reference(JMS._moe_ep_shardmap, jp, x, jcfg, shape[0])
    got, calls = _port(cfg, tp, x, shape)
    _close(got, want)
    assert calls["all_to_all"] == 2
    rows = B // shape[0]
    local = np.concatenate([
        MS.moe_ep_local(tp, torch.as_tensor(
            x[g * rows:(g + 1) * rows].reshape(-1, cfg.d_model)),
            cfg).reshape(rows, S, -1).numpy() for g in range(shape[0])])
    _close(local, want)
    dropped = sum(MS.ep_dropped(tp, torch.as_tensor(
        x[g * rows:(g + 1) * rows].reshape(-1, cfg.d_model)), cfg)
        for g in range(shape[0]))
    if cap == 8.0:                   # C past any expert's load
        assert dropped == 0
        _close(got, MOE.moe_ffn(tp, torch.as_tensor(
            x.reshape(-1, cfg.d_model)), cfg).reshape(B, S, -1).numpy())
    elif cap == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_layout_in_bf16_rounds_once(arch, shape):
    _, cfg, _, tp = _layer(arch, "tp", 0.0)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in tp.items()}
    x = torch.as_tensor(_x(cfg.d_model)).to(torch.bfloat16)

    def fn(mesh):
        with SH.use_rules(mesh), torch.no_grad():
            return MS.moe_ffn_dispatch(_pieces(mesh, cfg, tp), x, cfg)

    got = run_ranks(shape, fn, device="cpu")[0].float()
    xf = x.reshape(-1, cfg.d_model)
    w, e, _ = MOE.route(tp["router"], xf, cfg.moe)
    y = MOE.routed_ffn(tp, xf, cfg, w, e, f32=True)
    if cfg.moe.num_shared_experts:
        y = y + MOE.shared_ffn(tp, xf, f32=True)
    want = y.to(torch.bfloat16).float().reshape(got.shape)
    diff = (got - want).abs()
    assert float((diff > 0).float().mean()) <= 0.01
    assert float(diff.max()) <= 2 ** -8 * float(want.abs().max())
