"""Data-parallel training on a mesh of thread ranks, against the JAX package.

Ranks are threads over gloo from the package's runner (no subprocess).
Everything runs float32 on the CPU on reduced configs.

* ``optim.compression``: ``quantize``, ``dequantize``, ``flatten_tree``
  and ``unflatten_tree`` against the reference's; ``sync_mean`` at 4
  ranks against the reference's functions composed rank by rank;
* the data-parallel train step at 2 ranks (rows holding different
  numbers of masked targets) for ``gemma_2b``, ``qwen3_moe_30b_a3b`` and
  ``rwkv6_7b``, against ``jax.value_and_grad`` of the reference's global
  loss (the whole batch's; for the MoE model the NLL over the whole
  batch plus the MEAN of the shards' router aux terms, the reference's
  ``pmean``) and ``repro.optim.adamw``: the loss within 1e-5 relative,
  each updated leaf's step within 1e-4 of that leaf's largest step,
  plus the float32 rounding of the new parameter (AdamW at ``eps=1`` and
  ``lr=1``, where the update is smooth in the gradient and as large as
  it, so the step carries the gradient's agreement);
* the mesh's forward step gives that global loss on every rank;
* ZeRO-1 equals plain data parallelism bit for bit, parameters and
  (gathered) moments;
* the int8 error-feedback step at (2, 1) and (2, 2, 1) against the
  reference's two stages composed on one device: equal losses, and
  updates equal but where a float32 reordering moved a value across an
  int8 rounding tie (a handful of elements, each by at most one code);
  the residual nonzero;
* a 2-rank loop with ZeRO-1 and checkpoints every 2 steps: killed at 2
  and resumed, it ends bit for bit where the uninterrupted run ends, and
  its checkpoint holds whole leaves equal to the plain data-parallel
  run's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro.optim import compression as JC
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compression as C
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.compressed import (build_compressed_train_step,
                                          init_residual)
from repro_torch.train.loop import TrainLoopConfig, run
from repro_torch.tree import flatten_with_paths, tree_map

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
STEP_TOL = 1e-4
OPT_CFG = dict(lr_peak=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0)


# -- compression ---------------------------------------------------------------
def test_quantize_and_tree_layout_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=3 * C.BLOCK) * rng.uniform(0.01, 10)).astype(
        np.float32)
    x[C.BLOCK:2 * C.BLOCK] = 0.0                     # a zero block
    q, s = C.quantize(torch.as_tensor(x))
    jq, js = JC.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(C.dequantize(q, s).numpy(),
                                  np.asarray(JC.dequantize(jq, js)))
    tree = {"b": rng.normal(size=(3, 5)).astype(np.float32),
            "a": {"w": rng.normal(size=(9000,)).astype(np.float32),
                  "v": rng.normal(size=(2, 2)).astype(np.float32)}}
    vec, unflatten, shapes = C.flatten_tree(tree_map(torch.as_tensor, tree))
    jvec, jdef, jshapes = JC.flatten_tree(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    assert [(tuple(s), n) for s, n in shapes] == \
        [(tuple(s), n) for s, n in jshapes]
    back = C.unflatten_tree(vec * 2, unflatten, shapes)
    jback = JC.unflatten_tree(jvec * 2, jdef, jshapes)
    for a, b in zip(flatten_with_paths(back)[1],
                    flatten_with_paths(jax.tree.map(np.asarray, jback))[1]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_sync_mean_at_four_ranks_matches_reference_composition():
    rng = np.random.default_rng(1)
    n, L = 4, 2 * C.BLOCK
    vecs = [(rng.normal(size=L) * (r + 1)).astype(np.float32)
            for r in range(n)]
    ress = [(rng.normal(size=L) * 1e-3).astype(np.float32) for r in range(n)]

    def fn(mesh):
        mean, res = C.sync_mean(torch.as_tensor(vecs[mesh.rank]),
                                torch.as_tensor(ress[mesh.rank]), mesh,
                                "data")
        return mean.numpy(), res.numpy(), mesh.stats.to_dict()

    out = run_ranks((n, 1), fn, device="cpu")
    qs, ss, new_res = [], [], []
    for v, r in zip(vecs, ress):
        w = jnp.asarray(v) + jnp.asarray(r)
        q, s = JC.quantize(w)
        qs.append(q)
        ss.append(s)
        new_res.append(np.asarray(w - JC.dequantize(q, s)))
    total = sum(np.asarray(JC.dequantize(q, s)) for q, s in zip(qs, ss))
    want = total / n
    for r, (mean, res, stats) in enumerate(out):
        np.testing.assert_allclose(mean, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(res, new_res[r])
        # int8 codes + float32 scales, never a float32 sum
        assert stats["bytes"]["all_gather"] == L + 4 * (L // C.BLOCK)
        assert "all_reduce" not in stats["calls"]


# -- the data-parallel step ----------------------------------------------------
def _setup(arch, B=4, S=16, seed=0):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + len(arch))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((B, S)) < 0.2] = -1
    targets[0, :S // 2] = -1              # rows hold different counts
    batch = {"tokens": toks[:, :-1], "targets": targets}
    return jm, jp, np_params, build_model(cfg), cfg, batch


def _reference_step(jm, jp, batch, n_shards, *, moe):
    """jax.value_and_grad of the reference's global loss over the whole
    batch (NLL over the whole batch; for MoE, plus the mean of the
    shards' aux terms), then one repro.optim.adamw update."""
    B = batch["tokens"].shape[0]
    rows = B // n_shards
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        if not moe:
            return jm.loss(p, jb)[0]
        cnt = jnp.sum(jb["targets"] >= 0).astype(jnp.float32)
        total = 0.0
        for r in range(n_shards):
            sb = {k: v[r * rows:(r + 1) * rows] for k, v in jb.items()}
            loss, mets = jm.loss(p, sb)
            aux = jm.cfg.moe.router_aux_coef * mets["aux"] / max(1,
                                                                 jm.n_scan)
            c = jnp.sum(sb["targets"] >= 0).astype(jnp.float32)
            total = total + (loss - aux) * c / cnt + aux / n_shards
        return total

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        new, _, _ = JOPT.apply_updates(JOPT.AdamWConfig(**OPT_CFG), p, grads,
                                       JOPT.init_state(p))
        return loss, new

    loss, new = step(jp)
    return float(loss), jax.tree.map(np.asarray, new)


def _mesh_train(model, cfg, np_params, batch, shape, *, zero1=False,
                compressed=False):
    def fn(mesh):
        p = convert_params(np_params, cfg, device="cpu")
        opt_cfg = OPT.AdamWConfig(**OPT_CFG)
        local = STEPS.shard_batch(mesh, batch)
        if compressed:
            step = build_compressed_train_step(model, mesh, opt_cfg,
                                               remat=False)
            o = OPT.init_state(p)
            res = init_residual(p, mesh)
            p, o, res, m = step(p, o, res, local)
            return p, o, float(m["loss"]), res
        step = STEPS.build_train_step(model, opt_cfg, mesh=mesh, zero1=zero1,
                                      remat=False)
        oshard = step.in_shardings[1]
        o = STEPS.init_opt_state(mesh, p, oshard)
        p, o, m = step(p, o, local)
        return p, STEPS.gather_opt_state(mesh, o, oshard), float(m["loss"])

    return run_ranks(shape, fn, device="cpu")


def _step_close(name, new, old, want):
    step, wstep = new - old, want - old
    ulp = float(np.abs(want).max()) * np.finfo(np.float32).eps
    tol = STEP_TOL * max(float(np.abs(wstep).max()), 1e-30) + ulp
    np.testing.assert_allclose(step, wstep, rtol=0, atol=tol, err_msg=name)


@pytest.fixture(scope="module",
                params=["gemma_2b", "qwen3_moe_30b_a3b", "rwkv6_7b"])
def setup(request):
    """(arch, jax model, params, numpy params, port model, cfg, batch,
    the reference's (loss, updated params))."""
    arch = request.param
    jm, jp, np_params, model, cfg, batch = _setup(arch)
    ref = _reference_step(jm, jp, batch, 2, moe=cfg.moe is not None)
    return arch, jm, jp, np_params, model, cfg, batch, ref


def test_data_parallel_step_matches_the_global_step(setup):
    arch, jm, jp, np_params, model, cfg, batch, (jloss, jnew) = setup
    out = _mesh_train(model, cfg, np_params, batch, (2, 1))
    old = flatten_with_paths(np_params)[1]
    want = flatten_with_paths(jnew)[1]
    for p, o, loss in out:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        paths, leaves, _ = flatten_with_paths(p)
        for pth, t, o0, w in zip(paths, leaves, old, want):
            _step_close(pth, t.numpy(), o0, w)
    # every rank holds the same parameters, bit for bit
    for a, b in zip(flatten_with_paths(out[0][0])[1],
                    flatten_with_paths(out[1][0])[1]):
        assert torch.equal(a, b)


def test_mesh_forward_step_gives_the_global_loss(setup):
    arch, jm, jp, np_params, model, cfg, batch, (jloss, _) = setup

    def fn(mesh):
        p = convert_params(np_params, cfg, device="cpu")
        step = STEPS.build_forward_step(model, mesh=mesh)
        loss, mets = step(p, STEPS.shard_batch(mesh, batch))
        return float(loss), float(mets.get("aux", 0.0))

    out = run_ranks((2, 1), fn, device="cpu")
    for loss, aux in out:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert out[0] == out[1]


def test_zero1_equals_data_parallel_bitwise(setup):
    arch, jm, jp, np_params, model, cfg, batch, _ = setup
    plain = _mesh_train(model, cfg, np_params, batch, (2, 1))
    z = _mesh_train(model, cfg, np_params, batch, (2, 1), zero1=True)
    for (pp, po, pl), (zp, zo, zl) in zip(plain, z):
        assert pl == zl
        for a, b in zip(flatten_with_paths(pp)[1], flatten_with_paths(zp)[1]):
            assert torch.equal(a, b)
        for a, b in zip(flatten_with_paths(po)[1], flatten_with_paths(zo)[1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2, 1)])
def test_compressed_step_matches_reference_stages(shape):
    jm, jp, np_params, model, cfg, batch = _setup("gemma_2b", B=4)
    n = int(np.prod(shape))
    rows = batch["tokens"].shape[0] // n
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                      has_aux=True))
    vecs, losses = [], []
    for r in range(n):        # stage 1: each shard's own gradient
        sb = {k: v[r * rows:(r + 1) * rows] for k, v in jb.items()}
        (loss, _), g = grad(jp, sb)
        vec, treedef, shapes = JC.flatten_tree(g)
        vecs.append(vec)
        losses.append(float(loss))
    if len(shape) == 3:       # stage 2: exact over data, int8 over pod
        d = shape[1]
        groups = [sum(vecs[p * d:(p + 1) * d]) / d for p in range(shape[0])]
    else:
        groups = vecs
    deq = [JC.dequantize(*JC.quantize(v)) for v in groups]
    mean = sum(deq[1:], deq[0]) / len(deq)
    grads = JC.unflatten_tree(mean, treedef, shapes)
    jnew, _, _ = jax.jit(lambda p, g: JOPT.apply_updates(
        JOPT.AdamWConfig(**OPT_CFG), p, g, JOPT.init_state(p)))(jp, grads)
    want = flatten_with_paths(jax.tree.map(np.asarray, jnew))[1]
    old = flatten_with_paths(np_params)[1]
    out = _mesh_train(model, cfg, np_params, batch, shape, compressed=True)
    total = ties = 0
    for p, _, loss, res in out:
        np.testing.assert_allclose(loss, np.mean(losses), rtol=LOSS_RTOL)
        assert float(res.abs().max()) > 0
        for t, o0, w in zip(flatten_with_paths(p)[1], old, want):
            step, wstep = t.numpy() - o0, w - o0
            scale = max(float(np.abs(wstep).max()), 1e-30)
            bad = np.abs(step - wstep) > STEP_TOL * scale
            total += step.size
            ties += int(bad.sum())
            # a tie moves one code: at most 1/127 of the block's max
            assert np.all(np.abs(step - wstep) <= scale / 100)
    assert ties <= total * 1e-3, (ties, total)


# -- the loop under a mesh -----------------------------------------------------
def test_two_rank_zero1_loop_resumes_bitwise(tmp_path):
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=3)

    def train(ckpt_dir, total, zero1=True):
        def fn(mesh):
            step = STEPS.build_train_step(
                model, OPT.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                       total_steps=4),
                mesh=mesh, zero1=zero1, remat=False)
            p = STEPS.broadcast_params(mesh, model.init(mesh.rank,
                                                        device="cpu"))
            o = STEPS.init_opt_state(mesh, p, step.in_shardings[1])
            out = run(step, p, o, data,
                      TrainLoopConfig(total_steps=total, ckpt_every=2,
                                      ckpt_dir=str(ckpt_dir)),
                      device="cpu", log=lambda s: None)
            return out["params"], out["losses"]
        return run_ranks((2, 1), fn, device="cpu")

    full = train(tmp_path / "a", 4)
    train(tmp_path / "b", 2)
    resumed = train(tmp_path / "b", 4)
    plain = train(tmp_path / "c", 4, zero1=False)
    assert resumed[0][1] == full[0][1][2:]
    for r in range(2):
        for a, b in zip(flatten_with_paths(full[r][0])[1],
                        flatten_with_paths(resumed[r][0])[1]):
            assert torch.equal(a, b)
    # whole leaves on disk: the ZeRO-1 checkpoint equals plain DP's
    like = {"params": full[0][0],
            "opt": OPT.init_state(full[0][0])}
    za = CKPT.restore(str(tmp_path / "a"), 4, like)
    pc = CKPT.restore(str(tmp_path / "c"), 4, like)
    for a, b in zip(flatten_with_paths(za)[1], flatten_with_paths(pc)[1]):
        assert torch.equal(a, b)
