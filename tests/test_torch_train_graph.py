"""The one-pass AdamW update and the captured train step's host side,
against the JAX package, on the CPU.

* ``ops.adamw_update`` on CPU tensors runs ``ref.adamw_update_ref`` (the
  kernel's plain version) and counts no launch; through
  ``optim.adamw.apply_updates`` it matches ``repro.optim.adamw``'s
  ``upd`` leaf by leaf, float32 and bfloat16 with a float32 leaf, at
  leaf sizes 1, 7 and 4099 (the kernel's vector body and scalar tail),
  over clipped and unclipped steps, at ``test_apply_updates_matches_jax``'s
  tolerances; mixed devices, bad dtypes and shapes raise;
* the step counter is bumped in place: ``apply_updates`` returns the
  tensor it was given, whose count and learning rate follow JAX's;
* ``build_train_step``'s ``graph`` option: True on the CPU or with a mesh
  raises; the CPU's default step is eager, keeps stats, and one step
  matches ``jax.value_and_grad`` + ``repro.optim.adamw`` (loss 1e-5
  relative, each leaf's step within 1e-4 of its largest step);
* ``train.loop.run`` resumes into the tensors it was given (every
  parameter, moment and the step keep their ``data_ptr``), bit for bit;
* the launcher's ``--eager-step`` parses and trains.

The kernel itself, the capture, a recapture and the sync check run on
the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 14.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.optim import adamw as OPT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.loop import TrainLoopConfig, run
from repro_torch.train.step_graph import TrainStepGraphs
from repro_torch.tree import flatten_with_paths, leaves as tree_leaves

torch.set_num_threads(1)

F32_RTOL = 1e-5
STEP_TOL = 1e-4
#: AdamW at eps 1 and lr 1: the update is smooth in the gradient and as
#: large as it, so the step carries the gradient's agreement
SMOOTH_OPT = dict(lr_peak=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy(
        ).tobytes()


# -- the update, through apply_updates ------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_jax_upd_at_every_leaf_size(dtype):
    rng = np.random.default_rng(1)
    shapes = {"one": (1,), "seven": (7,), "big": (4099,), "router": (7, 3)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def leaf_dtype(path, jax_side):
        f32 = path.endswith("router")     # a float32 leaf in a bf16 tree
        if jax_side:
            return jnp.float32 if f32 else jdt
        return torch.float32 if f32 else tdt

    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    paths, vals, unflat = flatten_with_paths(init)
    jp = unflat([jnp.asarray(v, leaf_dtype(p, True))
                 for p, v in zip(paths, vals)])
    tp = unflat([torch.tensor(v).to(leaf_dtype(p, False))
                 for p, v in zip(paths, vals)])
    cfg = OPT.AdamWConfig(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2,
                          total_steps=4, weight_decay=0.1, clip_norm=1.0)
    jcfg = JOPT.AdamWConfig(**dataclasses.asdict(cfg))
    jst, tst = JOPT.init_state(jp), OPT.init_state(tp)
    before = ops.launch_counts()
    for step in range(4):
        scale = 30.0 if step in (0, 2) else 0.01     # clipped, unclipped
        g = [(rng.normal(size=v.shape) * scale).astype(np.float32)
             for v in vals]
        jg = unflat([jnp.asarray(x, leaf_dtype(p, True))
                     for p, x in zip(paths, g)])
        tg = unflat([torch.tensor(x).to(leaf_dtype(p, False))
                     for p, x in zip(paths, g)])
        jp, jst, jm = JOPT.apply_updates(jcfg, jp, jg, jst)
        tp, tst, tm = OPT.apply_updates(cfg, tp, tg, tst)
        assert (float(jm["grad_norm"]) > cfg.clip_norm) == (scale > 1)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=F32_RTOL)
    assert ops.launch_counts() == before
    for a, b, p in zip(tree_leaves(tp), tree_leaves(jp), paths):
        assert a.dtype == leaf_dtype(p, False), p
        if a.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -7,
                                       atol=1e-6, err_msg=p)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=p)
    for mine, theirs in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        for a, b in zip(tree_leaves(mine), tree_leaves(theirs)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-7)


def test_step_counter_is_bumped_in_place():
    cfg = OPT.AdamWConfig(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2,
                          total_steps=5)
    jcfg = JOPT.AdamWConfig(**dataclasses.asdict(cfg))
    tp = {"w": torch.ones(5)}
    jp = {"w": jnp.ones(5)}
    tst, jst = OPT.init_state(tp), JOPT.init_state(jp)
    counter, ptr = tst.step, tst.step.data_ptr()
    for i in range(5):
        g = np.full(5, 0.1 * (i + 1), np.float32)
        jp, jst, jm = JOPT.apply_updates(jcfg, jp, {"w": jnp.asarray(g)},
                                         jst)
        tp, tst, tm = OPT.apply_updates(cfg, tp, {"w": torch.tensor(g)}, tst)
        assert tst.step is counter and counter.data_ptr() == ptr
        assert counter.dtype == torch.int32 and counter.dim() == 0
        assert int(counter) == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(_np(tp["w"]), _np(jp["w"]), rtol=F32_RTOL)


# -- the wrapper on the CPU ----------------------------------------------------------
def _leaf(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=g).to(dtype)
    grad = torch.randn(n, generator=g).to(dtype)
    m = 0.1 * torch.randn(n, generator=g)
    v = torch.rand(n, generator=g) * 0.01
    scalars = [torch.tensor(x, dtype=torch.float32)
               for x in (0.5, 1e-3, 0.19, 0.0975)]
    return p, grad, m, v, scalars


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_wrapper_runs_the_plain_version_on_the_cpu(dtype, n):
    cfg = OPT.AdamWConfig()
    p, g, m, v, sc = _leaf(n, dtype, n)
    want = [t.clone() for t in (p, m, v)]
    ref.adamw_update_ref(*want[:1], g, *want[1:], *sc, cfg)
    before = ops.launch_counts()
    assert ops.adamw_update(p, g, m, v, *sc, cfg) is None
    assert ops.launch_counts() == before
    for a, b in zip((p, m, v), want):
        assert _bits(a) == _bits(b)
    assert not torch.equal(m, _leaf(n, dtype, n)[2])      # moved


def test_wrapper_updates_a_strided_slice_in_place():
    """A ZeRO-1 slice of a leaf (a narrowed view) is updated where it
    lies, the rest of the leaf untouched."""
    cfg = OPT.AdamWConfig()
    p, g, m, v, sc = _leaf(48, torch.float32, 3)
    whole = [t.view(6, 8) for t in (p, g, m, v)]
    keep = [t.clone() for t in whole]
    pieces = [t.narrow(1, 4, 4) for t in whole]
    assert not pieces[0].is_contiguous()
    want = [t.clone() for t in pieces]
    ref.adamw_update_ref(want[0], want[1], want[2], want[3], *sc, cfg)
    ops.adamw_update(*pieces, *sc, cfg)
    for k in (0, 2, 3):
        assert torch.equal(pieces[k], want[k])
        assert torch.equal(whole[k][:, :4], keep[k][:, :4])


@pytest.mark.parametrize("case", ["mixed device", "float16 p", "bf16 m",
                                  "int g", "scale not 0-d", "float64 lr",
                                  "shapes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    cfg = OPT.AdamWConfig()
    p, g, m, v, sc = _leaf(8, torch.float32, 0)
    err = TypeError
    if case == "mixed device":
        g, err = torch.empty(8, device="meta"), ValueError
    elif case == "float16 p":
        p = p.half()
    elif case == "bf16 m":
        m = m.bfloat16()
    elif case == "int g":
        g = g.int()
    elif case == "scale not 0-d":
        sc[0], err = sc[0].reshape(1), ValueError
    elif case == "float64 lr":
        sc[1] = sc[1].double()
    else:
        v, err = v[:7], ValueError
    with pytest.raises(err):
        ops.adamw_update(p, g, m, v, *sc, cfg)


# -- build_train_step's graph option ---------------------------------------------------
def test_graph_option_refuses_the_cpu_and_a_mesh():
    model = build_model(get_config("gemma_2b").reduced())
    cfg = OPT.AdamWConfig()
    with pytest.raises(ValueError, match="CUDA device"):
        STEPS.build_train_step(model, cfg, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        TrainStepGraphs(lambda *a: a, torch.device("cpu"), graph=True)

    def fn(mesh):
        with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 1"):
            STEPS.build_train_step(model, cfg, mesh=mesh, graph=True)
        return STEPS.build_train_step(model, cfg, mesh=mesh).graphs

    assert run_ranks((1, 1), fn, device="cpu") == [None]


def test_cpu_step_is_eager_and_matches_jax():
    arch = "gemma_2b"
    jm = jbuild_model(jget_config(arch).reduced())
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((2, 16)) < 0.2] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets}

    @jax.jit
    def jstep(p):
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda q: jm.loss(q, jb, remat=True)[0])(p)
        new, _, _ = JOPT.apply_updates(JOPT.AdamWConfig(**SMOOTH_OPT), p,
                                       grads, JOPT.init_state(p))
        return loss, new

    jloss, jnew = jstep(jp)
    step = STEPS.build_train_step(build_model(cfg),
                                  OPT.AdamWConfig(**SMOOTH_OPT),
                                  device="cpu")
    params = convert_params(np_params, cfg, device="cpu")
    ost = OPT.init_state(params)
    params, ost, mets = step(params, ost, batch)
    assert step.stats() == {"graph": False, "captures": 0, "recaptures": 0,
                            "replays": 0, "eager_steps": 1, "pool_bytes": 0,
                            "capture_s": 0.0}
    assert abs(float(mets["loss"]) - float(jloss)) <= \
        F32_RTOL * abs(float(jloss))
    paths, old, _ = flatten_with_paths(np_params)
    for pth, new, want, o in zip(paths, tree_leaves(params),
                                 tree_leaves(jax.tree.map(np.asarray, jnew)),
                                 old):
        d, w = _np(new) - o, want - o
        ulp = float(np.abs(want).max()) * np.finfo(np.float32).eps
        tol = STEP_TOL * max(float(np.abs(w).max()), 1e-30) + ulp
        np.testing.assert_allclose(d, w, rtol=0, atol=tol, err_msg=pth)


# -- resume in place, and the launcher --------------------------------------------------
def test_resume_copies_into_the_tensors_passed_in(tmp_path):
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=6)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                      seed=3)

    def go(name, total):
        params = model.init(seed=0, device="cpu")
        ost = OPT.init_state(params)
        given = tree_leaves({"p": params, "o": ost})
        lcfg = TrainLoopConfig(total_steps=total, ckpt_every=3,
                               ckpt_dir=str(tmp_path / name), log_every=100)
        out = run(STEPS.build_train_step(model, ocfg, device="cpu"), params,
                  ost, dcfg, lcfg, device="cpu", log=lambda *_: None)
        got = tree_leaves({"p": out["params"], "o": out["opt_state"]})
        assert len(got) == len(given)
        assert all(a is b and a.data_ptr() == b.data_ptr()
                   for a, b in zip(got, given))
        return out

    full = go("full", 6)
    go("cut", 3)
    assert CKPT.latest_step(str(tmp_path / "cut")) == 3
    resumed = go("cut", 6)
    assert full["losses"][3:] == resumed["losses"]
    assert int(resumed["opt_state"].step) == 6
    for a, b in zip(tree_leaves([full["params"], full["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert _bits(a) == _bits(b)


def test_launcher_takes_eager_step(tmp_path, capsys):
    out = train_main(["--arch", "gemma_2b", "--reduced", "--device", "cpu",
                      "--eager-step", "--steps", "3", "--batch", "2",
                      "--seq", "8", "--ckpt-every", "0",
                      "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "train step:" not in capsys.readouterr().out
    assert CKPT.latest_step(str(tmp_path)) is None
