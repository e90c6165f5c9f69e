"""The port's optimizer, data pipeline, block checkpoints, fault-tolerant
loop and training launcher against the JAX package, on the CPU.

* ``apply_updates``: 5 AdamW steps through warmup, the cosine and
  clipping, float32 and bfloat16 (with a float32 leaf in the bf16 tree),
  against ``repro.optim.adamw`` on the same numpy gradients;
* ``SyntheticLM`` and ``MemmapTokens`` (a numpy-written token file, its
  index a 2-level TreeArray) batches equal to the reference's bit for
  bit, and a resumed ``PrefetchIterator`` equal to ``batch_at``;
* checkpoints: round trip, fixed-size blocks, ``keep_last``, a crashed
  writer, and the format shared both ways: a JAX-written float32 and
  bfloat16 checkpoint of reduced gemma_2b's ``{"params", "opt"}``
  restores into the port bit for bit and the port's into
  ``repro.train.checkpoint``, after which one more training step on
  each side agrees;
* the loop: bitwise resume (8 steps against 4 + resume to 8), a
  non-finite loss that aborts with a checkpoint, the straggler monitor;
* the launcher: ``--arch gemma_2b --reduced --device cpu --steps 30
  --batch 4 --seq 32 --lr 3e-3`` lowers the loss by more than 0.5 and
  leaves ``latest_step == 30`` (the port's counterpart of the
  reference's ``tests/test_system.py::test_train_loop_end_to_end``);
  ``--model-parallel 2`` raises and ``--zero1`` trains at world 1.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data import pipeline as JDATA
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro.train import checkpoint as JCKPT
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as DATA
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.optim import adamw as OPT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.loop import StragglerMonitor, TrainLoopConfig, run
from repro_torch.tree import flatten_with_paths, leaves as tree_leaves

torch.set_num_threads(1)

F32_RTOL = 1e-5


def _np(t):
    """A tensor or JAX array as float32 numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _bits(t):
    """The raw bytes of a tensor or array, for bitwise comparison."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy(
            ).tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


# -- AdamW -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    rng = np.random.default_rng(0)
    shapes = {"embed": (16, 8), "layers": {"w": (3, 8, 8), "ln": (3, 8)},
              "router": (8, 4)}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def leaf_dtype(path, jax_side):
        f32 = path.endswith("router")     # a float32 leaf in a bf16 tree
        if jax_side:
            return jnp.float32 if f32 else jdt
        return torch.float32 if f32 else tdt

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return rng.normal(size=node).astype(np.float32)
    init = make(shapes)
    paths, leaves, unflat = flatten_with_paths(init)
    jp = unflat([jnp.asarray(v, leaf_dtype(p, True))
                 for p, v in zip(paths, leaves)])
    tp = unflat([torch.tensor(v).to(leaf_dtype(p, False))
                 for p, v in zip(paths, leaves)])
    cfg = OPT.AdamWConfig(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2,
                          total_steps=5, weight_decay=0.1, clip_norm=1.0)
    jcfg = JOPT.AdamWConfig(**dataclasses.asdict(cfg))
    jst, tst = JOPT.init_state(jp), OPT.init_state(tp)
    for step in range(5):
        # steps 0 and 3 are clipped (norm >> 1), the others not
        scale = 10.0 if step in (0, 3) else 0.02
        g = [(rng.normal(size=v.shape) * scale).astype(np.float32)
             for v in leaves]
        jg = unflat([jnp.asarray(x, leaf_dtype(p, True))
                     for p, x in zip(paths, g)])
        tg = unflat([torch.tensor(x).to(leaf_dtype(p, False))
                     for p, x in zip(paths, g)])
        jp, jst, jm = JOPT.apply_updates(jcfg, jp, jg, jst)
        tp, tst, tm = OPT.apply_updates(cfg, tp, tg, tst)
        assert int(tst.step) == int(jst.step) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=F32_RTOL)
        if scale == 10.0:
            assert float(jm["grad_norm"]) > cfg.clip_norm
    for a, b, p in zip(tree_leaves(tp), tree_leaves(jp), paths):
        assert a.dtype == leaf_dtype(p, False), p
        if a.dtype == torch.bfloat16:
            # the float32 updates agree to ~1e-7; rounding to bf16 may
            # land one ulp (2**-8 relative) apart
            np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -7,
                                       atol=1e-6, err_msg=p)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=F32_RTOL,
                                       atol=1e-7, err_msg=p)
    for mine, ref in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        for a, b in zip(tree_leaves(mine), tree_leaves(ref)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4,
                                       atol=1e-7)


def test_cosine_lr_matches_jax():
    cfg = OPT.AdamWConfig(lr_peak=3e-3, lr_min=1e-4, warmup_steps=4,
                          total_steps=20)
    jcfg = JOPT.AdamWConfig(**dataclasses.asdict(cfg))
    for s in range(0, 24):
        np.testing.assert_allclose(
            float(OPT.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))),
            float(JOPT.cosine_lr(jcfg, jnp.asarray(s, jnp.int32))),
            rtol=1e-6, err_msg=str(s))


# -- data pipeline -----------------------------------------------------------
def test_synthetic_batches_equal_reference():
    cfg = DATA.DataConfig(vocab_size=512, seq_len=32, global_batch=3,
                          seed=7)
    mine = DATA.SyntheticLM(cfg)
    ref = JDATA.SyntheticLM(JDATA.DataConfig(**dataclasses.asdict(cfg)))
    for step in (0, 1, 17, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            assert np.array_equal(a[k], b[k]), (step, k)


def test_memmap_batches_equal_reference(tmp_path):
    """A 40,001-token file at seq_len 4: 10,000 sequences, so the index
    is a depth-2 TreeArray of 8192-float leaves."""
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(3).integers(0, 1000, 40_001).astype(
        np.int32).tofile(path)
    cfg = DATA.DataConfig(vocab_size=1000, seq_len=4, global_batch=6,
                          seed=2, source="memmap", path=path)
    mine = DATA.make_source(cfg, device="cpu")
    ref = JDATA.make_source(JDATA.DataConfig(**dataclasses.asdict(cfg)))
    assert isinstance(mine, DATA.MemmapTokens)
    assert mine.n_seqs == ref.n_seqs == 10_000
    assert mine.index.depth == 2 and mine.index.leaves.dtype == torch.float32
    for step in (0, 5, 99):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert np.array_equal(a[k], b[k]), (step, k)


def test_prefetch_resume_matches_direct():
    cfg = DATA.DataConfig(vocab_size=100, seq_len=8, global_batch=2, seed=5)
    src = DATA.SyntheticLM(cfg)
    it = DATA.PrefetchIterator(src, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = next(it)
            assert step == want
            assert np.array_equal(batch["tokens"],
                                  src.batch_at(want)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_prefetch_hands_errors_to_the_consumer():
    class Broken:
        def batch_at(self, step):
            raise OSError(f"no batch {step}")
    it = DATA.PrefetchIterator(Broken(), start_step=3)
    try:
        with pytest.raises(OSError, match="no batch 3"):
            next(it)
    finally:
        it.close()


# -- checkpoints -------------------------------------------------------------
def _tree(rng):
    return {"a": torch.tensor(rng.randn(1000, 3).astype(np.float32)),
            "b": {"c": torch.tensor(rng.randn(7).astype(np.float16)),
                  "d": torch.tensor(rng.randint(0, 9, (4, 4)),
                                    dtype=torch.int32),
                  "h": torch.tensor(rng.randn(5, 3)).to(torch.bfloat16)},
            "e": [torch.tensor(rng.randn(2, 2, 2).astype(np.float32))],
            "s": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path, rng):
    t = _tree(rng)
    CKPT.save(str(tmp_path), 7, t, block_bytes=4096)  # multi-block
    assert CKPT.latest_step(str(tmp_path)) == 7
    r = CKPT.restore(str(tmp_path), 7, t)
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)


def test_checkpoint_blocks_are_fixed_size(tmp_path, rng):
    t = {"w": torch.tensor(rng.randn(5000).astype(np.float32))}  # 20 KB
    CKPT.save(str(tmp_path), 1, t, block_bytes=4096)
    bdir = os.path.join(str(tmp_path), "step_00000001", "blocks")
    sizes = sorted(os.path.getsize(os.path.join(bdir, f))
                   for f in os.listdir(bdir))
    assert sizes[-1] == 4096 and len(sizes) == 5     # 4 full + 1 tail
    assert CKPT.BLOCK_BYTES == JCKPT.BLOCK_BYTES == 4 * 1024 * 1024


def test_checkpoint_keep_last(tmp_path, rng):
    t = _tree(rng)
    for s in range(6):
        CKPT.save(str(tmp_path), s, t, keep_last=2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004",
                                                 "step_00000005"]


def test_checkpoint_crash_during_write_keeps_previous(tmp_path, rng):
    t = _tree(rng)
    CKPT.save(str(tmp_path), 1, t)
    # a crashed writer: an orphaned tmp dir with a partial block
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp", "blocks"))
    with open(os.path.join(str(tmp_path), "step_00000002.tmp", "blocks",
                           "00000_00000.bin"), "wb") as f:
        f.write(b"\0" * 10)
    assert CKPT.latest_step(str(tmp_path)) == 1
    r = CKPT.restore(str(tmp_path), 1, t)
    assert _bits(r["a"]) == _bits(t["a"])
    CKPT.save(str(tmp_path), 2, t)          # the next save cleans the orphan
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))


def _gemma(dtype):
    """Reduced gemma_2b in ``dtype`` on both sides, the reference's
    parameters converted, and one train step each (float32 AdamW)."""
    jcfg = dataclasses.replace(jget_config("gemma_2b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config("gemma_2b").reduced(), dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    jocfg = JOPT.AdamWConfig(**dataclasses.asdict(ocfg))

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda pp: jm.loss(pp, b), has_aux=True)(p)
        p, o, _ = JOPT.apply_updates(jocfg, p, g, o)
        return p, o, loss

    tstep = build_train_step(tm, ocfg, remat=False, device="cpu")
    data = DATA.SyntheticLM(DATA.DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=16, global_batch=2,
                                            seed=3))
    return jp, jstep, tm, tstep, data, cfg


def _one_step_agrees(tp, tst, tstep, jp, jst, jstep, batch, dtype):
    tp, tst, tm = tstep(tp, tst, batch)
    jp, jst, jl = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jl),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    lr = 1e-3               # step 2's: the peak, where warmup ends
    for pth, a, b in zip(flatten_with_paths(tp)[0], tree_leaves(tp),
                         tree_leaves(jp)):
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6,
                                       err_msg=pth)
        else:
            # bf16 gradients differ by rounding; Adam's normalised step
            # moves an element by at most ~lr, so a sign flip of a tiny
            # gradient costs 2 lr, on top of one bf16 ulp
            np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -7,
                                       atol=2 * lr + 1e-6, err_msg=pth)
    assert int(tst.step) == int(jst.step)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_packages(tmp_path, dtype):
    jp, jstep, tm, tstep, data, cfg = _gemma(dtype)
    jst = JOPT.init_state(jp)
    b0, b1 = data.batch_at(0), data.batch_at(1)
    jp, jst, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b0.items()})
    jtree = {"params": jp, "opt": jst}
    JCKPT.save(str(tmp_path / "jax"), 1, jtree)

    # the JAX-written checkpoint into the port, bit for bit
    like_p = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    like = {"params": like_p, "opt": OPT.init_state(like_p)}
    got = CKPT.restore(str(tmp_path / "jax"), 1, like)
    paths, mine, _ = flatten_with_paths(got)
    jpaths, ref, _ = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    assert paths == jpaths and "opt/.step" in paths
    assert "opt/.mu/embed" in paths and "params/layers/attn/wq" in paths
    for pth, a, b in zip(paths, mine, ref):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), pth
        assert _bits(a) == _bits(b), pth
    # the port's checkpoint into the reference, bit for bit
    CKPT.save(str(tmp_path / "port"), 1, got)
    back = JCKPT.restore(str(tmp_path / "port"), 1, jtree)
    for pth, a, b in zip(paths, mine, jax.tree.leaves(back)):
        assert _bits(a) == _bits(b), pth
    # one more step on each side agrees
    _one_step_agrees(got["params"], got["opt"], tstep, jp, jst, jstep, b1,
                     dtype)


def test_checkpoint_files_match_reference_layout(tmp_path):
    """Both packages name the same tensors' blocks alike."""
    rng = np.random.RandomState(0)
    t = {"w": rng.randn(3000).astype(np.float32),
         "b": {"z": np.arange(5, dtype=np.int32)}}
    CKPT.save(str(tmp_path / "p"), 4, {k: (torch.tensor(v) if not
                                           isinstance(v, dict) else
                                           {"z": torch.tensor(v["z"])})
                                       for k, v in t.items()},
              block_bytes=4096)
    JCKPT.save(str(tmp_path / "j"), 4, jax.tree.map(jnp.asarray, t),
               block_bytes=4096)
    import json

    def manifest(d):
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            return json.load(f)
    assert manifest(str(tmp_path / "p")) == manifest(str(tmp_path / "j"))
    for name in os.listdir(str(tmp_path / "j" / "step_00000004" / "blocks")):
        with open(tmp_path / "j" / "step_00000004" / "blocks" / name,
                  "rb") as f, open(tmp_path / "p" / "step_00000004" /
                                   "blocks" / name, "rb") as g:
            assert f.read() == g.read(), name


# -- the loop ------------------------------------------------------------------
def _setup(tmp, total, ckpt_every, dtype="float32"):
    cfg = dataclasses.replace(get_config("gemma_2b").reduced(), dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    # the schedule's horizon is fixed whatever this run's length:
    # resuming must not change the LR schedule
    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    step = build_train_step(model, ocfg, device="cpu")
    dcfg = DATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=2, seed=3)
    lcfg = TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every,
                           ckpt_dir=str(tmp), log_every=1000)
    return step, params, OPT.init_state(params), dcfg, lcfg


def _quiet(*_):
    pass


def test_resume_is_bitwise_identical(tmp_path):
    full = run(*_setup(tmp_path / "a", 8, 4), device="cpu", log=_quiet)
    run(*_setup(tmp_path / "b", 4, 4), device="cpu", log=_quiet)
    logs = []
    resumed = run(*_setup(tmp_path / "b", 8, 4), device="cpu",
                  log=logs.append)
    assert logs == ["[resume] restored step 4"]
    assert full["losses"][4:] == resumed["losses"]
    for a, b in zip(tree_leaves({"p": full["params"],
                                 "o": full["opt_state"]}),
                    tree_leaves({"p": resumed["params"],
                                 "o": resumed["opt_state"]})):
        assert _bits(a) == _bits(b)


def test_nonfinite_loss_aborts_with_checkpoint(tmp_path):
    step, p0, o0, dcfg, lcfg = _setup(tmp_path, 8, 100)
    calls = {"n": 0}

    def bad_step(p, o, b):
        calls["n"] += 1
        p, o, m = step(p, o, b)
        if calls["n"] == 3:
            m = dict(m, loss=torch.tensor(float("nan")))
        return p, o, m

    with pytest.raises(FloatingPointError, match="step 2"):
        run(bad_step, p0, o0, dcfg, lcfg, device="cpu", log=_quiet)
    assert CKPT.latest_step(str(tmp_path)) == 2


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0, ewma=0.5)
    events = []
    mon.on_straggler = lambda s, dt, wm: events.append((s, dt))
    for s in range(10):
        mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)         # 10x the watermark
    assert mon.n_stragglers == 1 and events[0][0] == 10
    assert mon.watermark < 0.2          # not poisoned by the slow sample
    assert not mon.observe(11, 0.1)
    assert mon.n_stragglers == 1


def test_train_step_leaves_params_as_leaves():
    """The step marks the leaves for autograd only while it runs, and
    leaves no ``.grad`` behind."""
    step, params, ost, dcfg, _ = _setup("unused", 1, 1)
    batch = DATA.SyntheticLM(dcfg).batch_at(0)
    params, ost, mets = step(params, ost, batch)
    for t in tree_leaves(params):
        assert t.is_leaf and not t.requires_grad and t.grad is None
    assert set(mets) >= {"loss", "nll", "grad_norm", "lr"}
    assert int(ost.step) == 1


def test_forward_step_gives_the_train_steps_loss():
    """``build_forward_step`` computes the loss the train step reports,
    without gradients and without touching the parameters."""
    from repro_torch.launch.steps import build_forward_step

    step, params, ost, dcfg, _ = _setup("unused", 1, 1)
    model = build_model(get_config("gemma_2b").reduced())
    batch = DATA.SyntheticLM(dcfg).batch_at(0)
    before = [t.clone() for t in tree_leaves(params)]
    loss, mets = build_forward_step(model, device="cpu")(params, batch)
    assert not loss.requires_grad and set(mets) == {"nll", "aux"}
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(params)))
    _, _, tm = step(params, ost, batch)
    assert float(loss) == float(tm["loss"])


# -- the launcher ----------------------------------------------------------------
def test_launcher_trains_and_checkpoints(tmp_path):
    out = train_main([
        "--arch", "gemma_2b", "--reduced", "--device", "cpu",
        "--steps", "30", "--batch", "4", "--seq", "32", "--lr", "3e-3",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    losses = out["losses"]
    assert len(losses) == 30
    # synthetic motifs are learnable: the loss must drop substantially
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert CKPT.latest_step(str(tmp_path)) == 30


@pytest.mark.parametrize("flags,match", [
    (["--model-parallel", "2"], "does not divide the world of 1 process"),
    (["--zero1"], None)], ids=["flags0-model-axis slice", "flags1-None"])
def test_launcher_refuses_sharding(tmp_path, flags, match):
    """``--model-parallel 2`` in a lone process raises before any step
    (a model axis of 2 needs a world it divides: two processes train
    in ``tests/test_torch_tp_train.py``); ``--zero1`` trains at world 1
    over a mesh of one rank, and its loss falls."""
    argv = ["--arch", "gemma_2b", "--reduced", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)] + flags
    if match is not None:
        with pytest.raises(ValueError, match=match):
            train_main(argv + ["--steps", "1"])
        assert CKPT.latest_step(str(tmp_path)) is None
        return
    out = train_main(argv + ["--steps", "30", "--batch", "4", "--seq", "32",
                             "--lr", "3e-3", "--ckpt-every", "10"])
    losses = out["losses"]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert CKPT.latest_step(str(tmp_path)) == 30
