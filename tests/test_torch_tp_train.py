"""Training over the model axis of the mesh, against the JAX package's
one-device step.

Ranks are threads of this process over gloo (``run_ranks(...,
device="cpu")``): on the CPU each thread runs its own backward pass, so
the model axis's collectives run inside autograd.  Reduced float32
decoder LMs -- ``gemma_2b`` (one KV head), ``gemma2_27b`` (softcaps,
post-norms, local/global windows), ``gemma3_27b`` (qk-norm) and
``minicpm3_4b`` (MLA with q-LoRA) -- take one train step from the
reference's converted weights on a batch of B 4, S 12 whose rows hold
different numbers of masked targets, on meshes:

* (1, 2): heads, MLP hidden dim and vocabulary split;
* (1, 3): nothing divides 3 but the sequence, so the weights replicate
  and attention is context-parallel over the sequence pieces;
* (1, 4): one query head a rank, a KV head read by two ranks (gemma2,
  gemma3) or by all four (gemma_2b);
* (2, 2): the data axis beside the model axis.

Each rank holds its pieces (``shard_params(copy=True)``); the gathered
parameters after one AdamW step (``eps`` 1, ``lr`` 1: the update is
smooth in the gradient and as large as it) must be within 1e-5 of each
leaf's maximum of ``jax.value_and_grad(model.loss)`` followed by
``repro.optim.adamw.apply_updates``, the loss and the clip norm within
1e-5 relative, and equal bits on every rank.  Sequence parallelism is on
by default; cases run with it off (``rules={"seq": None}``) and with
``remat`` off.  Then the forward step, ZeRO-1 on (2, 2) bit for bit
against the step without it, the int8 error-feedback step on (2, 2)
tracking the exact step (``tests/test_distributed.py``'s rule), a
planted fault (one column-parallel input's backward sum left out) that
must fail, a loop on (1, 2) that resumes bit for bit and writes whole
leaves that ``repro.train.checkpoint`` restores, and two tests of ranks
as processes: ``spawn_ranks`` with a planted failing rank, and the
launcher's ``--model-parallel 2`` on two processes against one.  The
MoE models are in ``tests/test_torch_tp_train_moe.py``.
"""

import functools
import os
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro.train import checkpoint as JCKPT
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks, spawn_processes, spawn_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.optim import adamw as OPT
from repro_torch.train.compressed import (build_compressed_train_step,
                                          init_residual)
from repro_torch.train.loop import TrainLoopConfig, run
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

B, S = 4, 12
TOL = 1e-5
OPT_CFG = dict(lr_peak=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0)
ARCHS = ["gemma_2b", "gemma2_27b", "gemma3_27b", "minicpm3_4b"]
MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]


def _ids(cases):
    return [f"{a}-{m[0]}x{m[1]}" for a, m in cases]


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((B, S)) < 0.2] = -1
    targets[0, :S // 2] = -1              # rows hold different counts
    return {"tokens": toks[:, :-1], "targets": targets}


@functools.lru_cache(maxsize=None)
def _reference(arch, n_shards):
    """(numpy parameters, batch, loss, clip norm, the updated leaves) of
    one step of the reference on one device: ``jax.value_and_grad`` of
    the global loss (an MoE model's aux term the mean of the
    ``n_shards`` data shards', the reference's ``pmean``), then
    ``repro.optim.adamw.apply_updates``."""
    jm = jbuild_model(jget_config(arch).reduced())
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rows = B // n_shards

    def loss_fn(p):
        if jm.cfg.moe is None:
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
        new, _, om = JOPT.apply_updates(JOPT.AdamWConfig(**OPT_CFG), p,
                                        grads, JOPT.init_state(p))
        return loss, om["grad_norm"], new

    loss, gnorm, new = step(jp)
    return (jax.tree.map(np.asarray, jp), batch, float(loss), float(gnorm),
            flatten_with_paths(jax.tree.map(np.asarray, new)))


def _mesh_step(cfg, np_params, batch, shape, *, rules=None, remat=True,
               zero1=False):
    """Every rank's (loss, clip norm, gathered parameters, gathered
    moments, collective calls) after one mesh train step."""
    model = build_model(cfg)

    def fn(mesh):
        whole = convert_params(np_params, cfg, device="cpu")
        step = STEPS.build_train_step(model, OPT.AdamWConfig(**OPT_CFG),
                                      mesh=mesh, remat=remat, zero1=zero1,
                                      rules=rules)
        pshard, oshard = step.in_shardings
        p = STEPS.shard_params(mesh, whole, pshard, copy=True)
        o = STEPS.init_opt_state(mesh, p, oshard)
        p, o, m = step(p, o, STEPS.shard_batch(mesh, batch))
        return (float(m["loss"]), float(m["grad_norm"]),
                STEPS.gather_params(mesh, p, pshard),
                STEPS.gather_opt_state(mesh, o, oshard),
                dict(mesh.stats.calls))

    return run_ranks(shape, fn, device="cpu")


def _leaf_gaps(params, want):
    """{path: max |got - want| / max |want|} over the leaves."""
    paths, leaves, _ = flatten_with_paths(params)
    assert paths == want[0]
    return {pth: float(np.abs(t.numpy() - w).max())
            / max(float(np.abs(w).max()), 1e-30)
            for pth, t, w in zip(paths, leaves, want[1])}


def _check(arch, shape, cfg=None, **kw):
    """One mesh step of ``arch`` on ``shape`` held to the reference
    (see the module docstring); returns the ranks' results."""
    np_params, batch, loss, gnorm, want = _reference(arch, shape[0])
    cfg = cfg or get_config(arch).reduced()
    out = _mesh_step(cfg, np_params, batch, shape, **kw)
    for r in out:
        assert r[0] == out[0][0] and r[1] == out[0][1]
        for a, b in zip(flatten_with_paths(r[2])[1],
                        flatten_with_paths(out[0][2])[1]):
            assert torch.equal(a, b)
    got_loss, got_norm, params = out[0][:3]
    np.testing.assert_allclose(got_loss, loss, rtol=TOL)
    np.testing.assert_allclose(got_norm, gnorm, rtol=TOL)
    gaps = _leaf_gaps(params, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL, (worst, gaps[worst])
    return out


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,shape", CASES, ids=_ids(CASES))
def test_tp_train_step_matches_one_device_reference(arch, shape):
    out = _check(arch, shape)
    calls = out[0][4]
    # sequence parallelism: gathers before the column-parallel products
    # (or the context-parallel K/V), reduce-scatters after
    assert calls["all_gather"] > 0 and calls["reduce_scatter"] > 0


SEQ_OFF = [(a, (1, 2)) for a in ARCHS] + [("minicpm3_4b", (1, 3))]


@pytest.mark.parametrize("arch,shape", SEQ_OFF, ids=_ids(SEQ_OFF))
def test_tp_train_step_without_sequence_parallelism(arch, shape):
    out = _check(arch, shape, rules={"seq": None})
    calls = out[0][4]
    if shape[1] == 2:
        # plain Megatron: the row-parallel sums and their adjoints
        assert "reduce_scatter" not in calls and calls["all_reduce"] > 0


REMAT_OFF = [("gemma2_27b", (1, 2)), ("minicpm3_4b", (1, 3))]


@pytest.mark.parametrize("arch,shape", REMAT_OFF, ids=_ids(REMAT_OFF))
def test_tp_train_step_without_remat(arch, shape):
    _check(arch, shape, remat=False)


@pytest.mark.parametrize("arch,shape", [("gemma_2b", (2, 2)),
                                        ("minicpm3_4b", (1, 3))],
                         ids=["gemma_2b-2x2", "minicpm3_4b-1x3"])
def test_tp_forward_step_gives_the_global_loss(arch, shape):
    np_params, batch, loss, _, _ = _reference(arch, shape[0])
    cfg = get_config(arch).reduced()
    model = build_model(cfg)

    def fn(mesh):
        whole = convert_params(np_params, cfg, device="cpu")
        step = STEPS.build_forward_step(model, mesh=mesh)
        p = STEPS.shard_params(mesh, whole, step.in_shardings, copy=True)
        before = [t.clone() for t in flatten_with_paths(p)[1]]
        got, mets = step(p, STEPS.shard_batch(mesh, batch))
        same = all(torch.equal(a, b) for a, b in
                   zip(before, flatten_with_paths(p)[1]))
        return float(got), not got.requires_grad, same

    out = run_ranks(shape, fn, device="cpu")
    for got, no_grad, same in out:
        assert got == out[0][0] and no_grad and same
    np.testing.assert_allclose(out[0][0], loss, rtol=TOL)


def test_tp_zero1_equals_the_plain_step_bitwise():
    np_params, batch, _, _, _ = _reference("gemma2_27b", 2)
    cfg = get_config("gemma2_27b").reduced()
    plain = _mesh_step(cfg, np_params, batch, (2, 2))
    z = _mesh_step(cfg, np_params, batch, (2, 2), zero1=True)
    for (pl, pn, pp, po, _), (zl, zn, zp, zo, _) in zip(plain, z):
        assert (pl, pn) == (zl, zn)
        for a, b in zip(flatten_with_paths((pp, po))[1],
                        flatten_with_paths((zp, zo))[1]):
            assert torch.equal(a, b)


def test_tp_int8_step_tracks_the_exact_step():
    """The int8 error-feedback step on (2, 2) against the exact step on
    the same mesh: ``tests/test_distributed.py``'s rule (the parameters'
    relative distance below 2e-3, a nonzero residual).  Its loss is the
    mean of the shards' means (the reference's), which the rows' unequal
    target counts set apart from the exact step's global mean."""
    np_params, batch, _, _, _ = _reference("gemma_2b", 2)
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=5)

    def fn(mesh):
        local = STEPS.shard_batch(mesh, batch)
        out = []
        for compressed in (False, True):
            whole = convert_params(np_params, cfg, device="cpu")
            if compressed:
                step = build_compressed_train_step(model, mesh, ocfg)
            else:
                step = STEPS.build_train_step(model, ocfg, mesh=mesh)
            pshard, oshard = step.in_shardings
            p = STEPS.shard_params(mesh, whole, pshard, copy=True)
            o = STEPS.init_opt_state(mesh, p, oshard)
            if compressed:
                res = init_residual(p, mesh)
                p, o, res, m = step(p, o, res, local)
            else:
                p, o, m = step(p, o, local)
            out.append((float(m["loss"]),
                        STEPS.gather_params(mesh, p, pshard)))
        return out, float(res.abs().max())

    for (exact, comp), res in run_ranks((2, 2), fn, device="cpu"):
        assert np.isfinite(comp[0]) and abs(comp[0] - exact[0]) < 1e-2 * \
            abs(exact[0])
        num = den = 0.0
        for a, b in zip(flatten_with_paths(exact[1])[1],
                        flatten_with_paths(comp[1])[1]):
            num += float(((a - b) ** 2).sum())
            den += float((a ** 2).sum())
        assert (num / den) ** 0.5 < 2e-3
        assert res > 0


def test_planted_fault_leaves_the_limit(monkeypatch):
    """One column-parallel input's backward sum left out (each rank's
    first sequence gather in the backward pass keeps its own share):
    the step must fall outside the limit the real one meets."""
    np_params, batch, loss, gnorm, want = _reference("gemma2_27b", 1)
    cfg = get_config("gemma2_27b").reduced()
    real = SH._GatherSeq.backward
    seen = threading.local()

    def faulty(ctx, g):
        if getattr(seen, "done", False):
            return real(ctx, g)
        seen.done = True
        n = g.shape[ctx.dim] // ctx.mesh.shape["model"]
        return g.narrow(ctx.dim, ctx.mesh.axis_index("model") * n,
                        n).contiguous(), None, None

    monkeypatch.setattr(SH._GatherSeq, "backward", staticmethod(faulty))
    out = _mesh_step(cfg, np_params, batch, (1, 2))
    np.testing.assert_allclose(out[0][0], loss, rtol=TOL)   # forward intact
    gaps = _leaf_gaps(out[0][2], want)
    assert max(gaps.values()) > 100 * TOL
    assert abs(out[0][1] - gnorm) > TOL * gnorm


def test_tp_loop_resumes_bitwise_and_writes_whole_leaves(tmp_path):
    """A loop on (1, 2): 4 steps against 2 + resume to 4, bit for bit;
    its checkpoint holds whole leaves, which ``repro.train.checkpoint``
    restores equal to the gathered pieces."""
    np_params, _, _, _, _ = _reference("gemma2_27b", 1)
    cfg = get_config("gemma2_27b").reduced()
    model = build_model(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=3)

    def train(ckpt_dir, total):
        def fn(mesh):
            step = STEPS.build_train_step(
                model, OPT.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                       total_steps=4), mesh=mesh)
            pshard, oshard = step.in_shardings
            p = STEPS.shard_params(mesh, convert_params(
                np_params, cfg, device="cpu"), pshard, copy=True)
            o = STEPS.init_opt_state(mesh, p, oshard)
            out = run(step, p, o, data,
                      TrainLoopConfig(total_steps=total, ckpt_every=2,
                                      ckpt_dir=str(ckpt_dir)),
                      device="cpu", log=lambda s: None)
            return (STEPS.gather_params(mesh, out["params"], pshard),
                    out["losses"])
        return run_ranks((1, 2), fn, device="cpu")

    full = train(tmp_path / "a", 4)
    train(tmp_path / "b", 2)
    resumed = train(tmp_path / "b", 4)
    assert resumed[0][1] == full[0][1][2:]
    for a, b in zip(flatten_with_paths(full[0][0])[1],
                    flatten_with_paths(resumed[0][0])[1]):
        assert torch.equal(a, b)
    jm = jbuild_model(jget_config("gemma2_27b").reduced())
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    back = JCKPT.restore(str(tmp_path / "a"), 4,
                         {"params": jp, "opt": JOPT.init_state(jp)})
    paths, leaves, _ = flatten_with_paths(full[0][0])
    got = flatten_with_paths(jax.tree.map(np.asarray, back["params"]))
    assert got[0] == paths
    for pth, a, b in zip(paths, leaves, got[1]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=pth)


def test_remat_recomputes_under_the_forward_rules_on_another_thread():
    """On the card autograd runs the backward pass, and with it remat's
    recomputation, on its device thread, where no sharding rules are
    active.  Here each rank's backward pass is called from a fresh
    thread: the gradients must equal those of a backward pass on the
    rank's own thread, bit for bit."""
    np_params, batch, _, _, _ = _reference("gemma_2b", 1)
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)

    def fn(mesh):
        pshard = STEPS.param_placements(model, mesh)
        rules = STEPS.rules_for(cfg, mesh)
        b = STEPS.batch_to(STEPS.shard_batch(mesh, batch), "cpu")
        out = []
        for elsewhere in (False, True):
            p = STEPS.shard_params(mesh, convert_params(
                np_params, cfg, device="cpu"), pshard, copy=True)
            leaves = flatten_with_paths(p)[1]
            for t in leaves:
                t.requires_grad_(True)
            with SH.use_rules(mesh, rules, {"seq": S}):
                loss = model.loss(p, b, remat=True)[0] / mesh.shape["model"]
            if elsewhere:
                err = []

                def back():
                    try:
                        loss.backward()
                    except BaseException as e:    # re-raised below
                        err.append(e)

                t = threading.Thread(target=back)
                t.start()
                t.join()
                if err:
                    raise err[0]
            else:
                loss.backward()
            out.append([t.grad for t in leaves])
        return all(torch.equal(a, b) for a, b in zip(*out))

    assert run_ranks((1, 2), fn, device="cpu") == [True, True]


# -- ranks as processes -------------------------------------------------------
def _failing_rank(mesh):
    """Rank 1 fails; rank 0 waits in a collective its peer never joins."""
    if mesh.rank == 1:
        raise ValueError("planted failure on rank 1")
    mesh.all_reduce(torch.zeros(4), "model")
    return "unreachable"


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_spawn_ranks_raises_the_earliest_failure_and_leaves_no_child():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="planted failure on rank 1"):
        spawn_ranks((1, 2), _failing_rank, device="cpu", timeout=3.0,
                    deadline=30.0)
    assert time.monotonic() - t0 < 20.0
    # spawn_processes reaps every child: none of this test's remains
    out = spawn_processes(2, ["-c", "import os; print(os.getpid())"],
                          timeout=3.0, deadline=20.0)
    pids = [int(p.stdout) for p in out]
    assert [p.returncode for p in out] == [0, 0]
    assert not any(_alive(pid) for pid in pids)


def test_launcher_model_parallel_on_two_processes(tmp_path):
    """``--model-parallel 2`` on two processes (gloo on the CPU, sequence
    parallelism on): 3 steps of reduced gemma_2b whose losses equal the
    one-process launcher's within 1e-5."""
    argv = ["--arch", "gemma_2b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3",
            "--ckpt-every", "0", "--log-every", "1"]
    one = train_main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    procs = spawn_processes(
        2, ["-m", "repro_torch.launch.train", *argv, "--model-parallel", "2",
            "--ckpt-dir", str(tmp_path / "two")], timeout=10.0,
        deadline=60.0)
    assert [p.returncode for p in procs] == [0, 0], procs[0].stderr[-2000:]
    two = [float(x) for x in re.findall(r"\] loss=([0-9.]+)", procs[0].stdout)]
    assert len(two) == 3 and not re.findall(r"\] loss=", procs[1].stdout)
    np.testing.assert_allclose(two, one, rtol=TOL)
    assert "rank 1:" in procs[0].stdout
