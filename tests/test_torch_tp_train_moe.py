"""Training the MoE decoders over the model axis of the mesh, against the
JAX package.

Reduced float32 ``qwen3_moe_30b_a3b`` (qk-norm, 8 experts top 2) and
``deepseek_v2_lite_16b`` (MLA, shared experts, a leading dense layer)
in both expert layouts take one train step on the meshes and batch of
``tests/test_torch_tp_train.py``, held to the same limits against
``jax.value_and_grad`` of the reference's global loss (its router aux
term the mean of the data shards', the reference's ``pmean``) and one
``repro.optim.adamw`` step: ``tp`` splits each expert's hidden dim,
``ep`` exchanges the capacity buffers (at ``capacity_factor`` = E,
where nothing drops and the layer is the dropless one the reference
computes on one device; 8 experts do not split over 3 ranks).  Cases
with sequence parallelism off and with ``remat`` off; the forward step
on (2, 2).  Then one MoE layer's gradients -- every leaf's and the
input's -- in both layouts (``ep`` at capacity 0.5, which drops
replicas) against ``jax.grad`` of the reference's ``_moe_tp_shardmap``
/ ``_moe_ep_shardmap`` on a ``jax.make_mesh((1, 1), ...)``, run per data
shard: each rank's objective is its share (1 / tp of its shard's), and
the shares are summed as the train step sums them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe_sharded as JMS
from repro_torch.configs.base import get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe_sharded as MS
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from test_torch_moe_parallel import _layer, _x
from test_torch_tp_train import MESHES, TOL, _check, _reference

torch.set_num_threads(1)

LAYOUTS = [("qwen3_moe_30b_a3b", "tp"), ("deepseek_v2_lite_16b", "tp"),
           ("qwen3_moe_30b_a3b", "ep"), ("deepseek_v2_lite_16b", "ep")]
CASES = [(a, mode, m) for a, mode in LAYOUTS for m in MESHES
         if not (mode == "ep" and m[1] == 3)]


def _ids(cases):
    return [f"{a}-{mode}-{m[0]}x{m[1]}" for a, mode, m in cases]


def _cfg(arch, mode):
    cfg = get_config(arch).reduced()
    if mode == "ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, parallel_mode="ep",
            capacity_factor=float(cfg.moe.num_experts)))
    return cfg


@pytest.mark.parametrize("arch,mode,shape", CASES, ids=_ids(CASES))
def test_moe_tp_train_step_matches_one_device_reference(arch, mode, shape):
    out = _check(arch, shape, cfg=_cfg(arch, mode))
    if mode == "ep":
        assert out[0][4]["all_to_all"] > 0


OFF = [("qwen3_moe_30b_a3b", "tp", (1, 2)),
       ("deepseek_v2_lite_16b", "ep", (1, 2))]


@pytest.mark.parametrize("arch,mode,shape", OFF, ids=_ids(OFF))
def test_moe_tp_train_step_without_sequence_parallelism(arch, mode, shape):
    _check(arch, shape, cfg=_cfg(arch, mode), rules={"seq": None})


def test_moe_tp_train_step_without_remat():
    _check("deepseek_v2_lite_16b", (2, 2),
           cfg=_cfg("deepseek_v2_lite_16b", "tp"), remat=False)


def test_moe_forward_step_gives_the_global_loss():
    np_params, batch, loss, _, _ = _reference("qwen3_moe_30b_a3b", 2)
    cfg = _cfg("qwen3_moe_30b_a3b", "ep")
    model = build_model(cfg)

    def fn(mesh):
        whole = convert_params(np_params, cfg, device="cpu")
        step = STEPS.build_forward_step(model, mesh=mesh)
        p = STEPS.shard_params(mesh, whole, step.in_shardings, copy=True)
        got, mets = step(p, STEPS.shard_batch(mesh, batch))
        return float(got), float(mets["aux"])

    out = run_ranks((2, 2), fn, device="cpu")
    assert all(r == out[0] for r in out)
    np.testing.assert_allclose(out[0][0], loss, rtol=TOL)


# -- one MoE layer's gradients against the reference's shard_maps -------------
LAYER_CASES = [(a, mode, cap, m) for a in ("qwen3_moe_30b_a3b",
                                           "deepseek_v2_lite_16b")
               for mode, cap in (("tp", 0.0), ("ep", 0.5))
               for m in ((1, 2), (2, 2))]


@pytest.mark.parametrize("arch,mode,cap,shape", LAYER_CASES, ids=[
    f"{a}-{mode}-{m[0]}x{m[1]}" for a, mode, _, m in LAYER_CASES])
def test_one_moe_layer_gradients_match_the_shard_maps(arch, mode, cap,
                                                      shape):
    jcfg, cfg, jp, lp = _layer(arch, mode, cap)
    x = _x(cfg.d_model)
    c = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    dp = shape[0]
    rows = x.shape[0] // dp
    fn = JMS._moe_ep_shardmap if mode == "ep" else JMS._moe_tp_shardmap
    jmesh = jax.make_mesh((1, 1), ("data", "model"))

    def objective(p, xs):
        total = 0.0
        for g in range(dp):
            y, aux = fn(p, xs[g * rows:(g + 1) * rows], jcfg, jmesh)
            total = total + jnp.sum(y * c[g * rows:(g + 1) * rows]) + aux / dp
        return total

    jg, jx = jax.jit(jax.grad(objective, argnums=(0, 1)))(jp, jnp.asarray(x))
    model = build_model(cfg)

    def rank(mesh):
        spec = {k: v[1:] for k, v in STEPS.param_placements(
            model, mesh)["layers"]["ff"].items()}
        mine = {k: SH.local_piece(mesh, v, spec[k]).clone().requires_grad_()
                for k, v in lp.items()}
        xs = torch.as_tensor(STEPS.shard_batch(mesh, {"x": x})["x"])
        xs.requires_grad_()
        cs = torch.as_tensor(STEPS.shard_batch(mesh, {"c": c})["c"])
        with SH.use_rules(mesh):
            y, aux = MS.moe_ffn_dispatch(mine, xs, cfg, with_aux=True)
            ((y * cs).sum() + aux / dp).div(mesh.shape["model"]).backward()
        grads = {k: v.grad for k, v in mine.items()}
        STEPS._sum_grads(mesh, grads, spec)
        gx = mesh.all_reduce(xs.grad.clone(), "model")
        return ({k: SH.gather_piece(mesh, g, spec[k]) for k, g in
                 grads.items()}, STEPS.gather_rows(mesh, gx))

    out = run_ranks(shape, rank, device="cpu")
    for k in lp:
        want = np.asarray(jg[k])
        scale = float(np.abs(want).max())
        for g, _ in out:
            np.testing.assert_allclose(g[k].numpy(), want, rtol=0,
                                       atol=TOL * scale, err_msg=k)
    want = np.asarray(jx)
    for _, gx in out:
        np.testing.assert_allclose(gx.numpy(), want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))
