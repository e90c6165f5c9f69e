"""The constant-state families over the model axis of the mesh, against
the JAX package's one-device numbers.

Ranks are threads of this process over gloo (``run_ranks(...,
device="cpu")``), each running its own backward pass.  Reduced float32
``mamba2_370m`` (16 SSD heads of 16, an ``in_proj`` packing ``[z | x | B
| C | dt]``), ``rwkv6_7b`` (4 heads of 32, an untied vocab-parallel
head) and ``zamba2_2p7b`` (two groups of six Mamba2 layers, each
followed by the shared GQA block with the group's LoRA) on meshes:

* (1, 2) and (1, 4): the SSM heads, the attention and MLP heads and the
  vocabulary split; a rank holds its heads' columns of ``z``, ``x`` and
  ``dt`` with ``B`` and ``C`` whole (``shardings.Packed``);
* (1, 3): no head count divides 3, so the mixers replicate, each runs
  the whole sequence and keeps its piece, and Zamba2's attention goes
  context-parallel over the sequence pieces;
* (2, 2): the data axis beside the model axis.

One train step from the reference's converted weights on a batch of B 4,
S 24 (a multiple of the chunk, 8, and of 2, 3 and 4, so sequence
parallelism runs on every mesh), held as ``tests/test_torch_tp_train.py``
holds the decoder LMs: after one AdamW step (``eps`` 1, ``lr`` 1) every
gathered leaf within 1e-5 of its maximum of ``jax.value_and_grad`` +
``repro.optim.adamw``, the loss and the clip norm within 1e-5 relative,
equal bits on every rank; cases with sequence parallelism off and with
``remat`` off; the reference's own parity case (``rwkv6_7b``, B 4, S 16,
remat, on (4, 2)); a rank's pieces of the packed leaves and a
checkpoint of whole leaves.  Then the serve and prefill steps of ``rwkv6_7b``
and ``zamba2_2p7b`` against the reference's one-device ``prefill`` and
``decode_step`` (1e-5 of max |logit|, equal greedy tokens); Mamba2's
mesh serve and prefill steps refusing a ``Mamba2State`` with
``TypeError``, as the reference's ``state_shardings`` does; the
placements against the reference's with the documented differences;
two planted faults (the norm's model-axis sum of squares left out, a
per-head replicated leaf's gradient left unsummed), each of which must
fail; and the launcher's ``--model-parallel 2`` on two processes.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch import shardings as JSH
from repro.launch import steps as JSTEPS
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro.train import checkpoint as JCKPT
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks, spawn_processes
from repro_torch.launch.train import main as train_main
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.optim import adamw as OPT
from repro_torch.train.loop import TrainLoopConfig, run
from repro_torch.tree import flatten_with_paths
from test_torch_mesh import _axes_leaves, _jspecs, _meshes, _state_leaves
from test_torch_tp_train import OPT_CFG, TOL, _leaf_gaps, _mesh_step

torch.set_num_threads(1)

B, S = 4, 24
ARCHS = ["mamba2_370m", "rwkv6_7b", "zamba2_2p7b"]
MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]


def _ids(cases):
    return [f"{a}-{m[0]}x{m[1]}" for a, m in cases]


def _batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((b, s)) < 0.2] = -1
    targets[0, :s // 2] = -1              # rows hold different counts
    return {"tokens": toks[:, :-1], "targets": targets}


def _reference(arch, b=B, s=S):
    """(numpy parameters, batch, loss, clip norm, the updated leaves) of
    one step of the reference on one device."""
    return _reference_at(arch, b, s)


@functools.lru_cache(maxsize=None)
def _reference_at(arch, b, s):
    jm = jbuild_model(jget_config(arch).reduced())
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    batch = _batch(jm.cfg, b, s)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(lambda q: jm.loss(q, jb)[0])(p)
        new, _, om = JOPT.apply_updates(JOPT.AdamWConfig(**OPT_CFG), p,
                                        grads, JOPT.init_state(p))
        return loss, om["grad_norm"], new

    loss, gnorm, new = step(jp)
    return (jax.tree.map(np.asarray, jp), batch, float(loss), float(gnorm),
            flatten_with_paths(jax.tree.map(np.asarray, new)))


def _check(arch, shape, *, b=B, s=S, **kw):
    """One mesh step of ``arch`` on ``shape`` held to the reference;
    returns the ranks' results."""
    np_params, batch, loss, gnorm, want = _reference(arch, b, s)
    out = _mesh_step(get_config(arch).reduced(), np_params, batch, shape,
                     **kw)
    for r in out:
        assert r[0] == out[0][0] and r[1] == out[0][1]
        for x, y in zip(flatten_with_paths(r[2])[1],
                        flatten_with_paths(out[0][2])[1]):
            assert torch.equal(x, y)
    got_loss, got_norm, params = out[0][:3]
    np.testing.assert_allclose(got_loss, loss, rtol=TOL)
    np.testing.assert_allclose(got_norm, gnorm, rtol=TOL)
    gaps = _leaf_gaps(params, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL, (worst, gaps[worst])
    return out


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,shape", CASES, ids=_ids(CASES))
def test_state_tp_train_step_matches_one_device_reference(arch, shape):
    out = _check(arch, shape)
    calls = out[0][4]
    # sequence parallelism: every mixer gathers the whole sequence; a
    # split one reduce-scatters its row-parallel sum, a whole one keeps
    # its piece
    assert calls["all_gather"] > 0
    if shape[1] != 3:
        assert calls["reduce_scatter"] > 0 and calls["all_reduce"] > 0


SEQ_OFF = [(a, (1, 2)) for a in ARCHS]


@pytest.mark.parametrize("arch,shape", SEQ_OFF, ids=_ids(SEQ_OFF))
def test_state_tp_train_step_without_sequence_parallelism(arch, shape):
    calls = _check(arch, shape, rules={"seq": None})[0][4]
    assert "reduce_scatter" not in calls and calls["all_reduce"] > 0


REMAT_OFF = [("mamba2_370m", (1, 2)), ("zamba2_2p7b", (1, 4))]


@pytest.mark.parametrize("arch,shape", REMAT_OFF, ids=_ids(REMAT_OFF))
def test_state_tp_train_step_without_remat(arch, shape):
    _check(arch, shape, remat=False)


def test_reference_parity_case_rwkv6_on_4x2():
    """``tests/test_distributed.py``'s ``rwkv6_7b`` case -- B 4, S 16,
    remat, a (4, 2) mesh -- held to the one-device step."""
    _check("rwkv6_7b", (4, 2), b=4, s=16)


def test_packed_pieces_and_a_checkpoint_of_whole_leaves(tmp_path):
    """A rank holds its heads' columns of ``in_proj`` with ``B``/``C``
    whole, never the whole leaf; a (1, 2) loop writes whole leaves that
    ``repro.train.checkpoint`` restores equal to the gathered pieces."""
    np_params, _, _, _, _ = _reference("mamba2_370m")
    cfg = get_config("mamba2_370m").reduced()
    model = build_model(cfg)
    s = cfg.ssm
    di, N = s.expand * cfg.d_model, s.state_dim
    H = di // s.head_dim
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=B,
                      seed=3)

    def fn(mesh):
        step = STEPS.build_train_step(
            model, OPT.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                   total_steps=2), mesh=mesh)
        pshard, oshard = step.in_shardings
        whole = convert_params(np_params, cfg, device="cpu")
        p = STEPS.shard_params(mesh, whole, pshard, copy=True)
        i, hl, dl = mesh.axis_index("model"), H // 2, di // 2
        w = whole["layers"]["mamba"]["in_proj"]
        want = torch.cat([w[..., i * dl:(i + 1) * dl],
                          w[..., di + i * dl: di + (i + 1) * dl],
                          w[..., 2 * di: 2 * di + 2 * N],
                          w[..., 2 * di + 2 * N + i * hl:
                            2 * di + 2 * N + (i + 1) * hl]], dim=-1)
        mine = torch.equal(p["layers"]["mamba"]["in_proj"], want)
        o = STEPS.init_opt_state(mesh, p, oshard)
        out = run(step, p, o, data,
                  TrainLoopConfig(total_steps=2, ckpt_every=2,
                                  ckpt_dir=str(tmp_path)),
                  device="cpu", log=lambda m: None)
        return mine, STEPS.gather_params(mesh, out["params"], pshard)

    def pieces(mesh):
        pshard = STEPS.param_placements(model, mesh)
        whole = convert_params(np_params, cfg, device="cpu")
        p = STEPS.shard_params(mesh, whole, pshard)
        back = STEPS.gather_params(mesh, p, pshard)
        return (tuple(p["layers"]["mamba"]["in_proj"].shape),
                tuple(p["layers"]["mamba"]["conv_w"].shape),
                all(torch.equal(x, y) for x, y in zip(
                    flatten_with_paths(back)[1],
                    flatten_with_paths(whole)[1])))

    L, d = cfg.num_layers, cfg.d_model
    assert run_ranks((1, 2), pieces, device="cpu") == [
        ((L, d, di + 2 * N + H // 2), (L, 4, di // 2 + 2 * N), True)] * 2
    out = run_ranks((1, 2), fn, device="cpu")
    assert out[0][0]
    jm = jbuild_model(jget_config("mamba2_370m").reduced())
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    back = JCKPT.restore(str(tmp_path), 2,
                         {"params": jp, "opt": JOPT.init_state(jp)})
    paths, leaves, _ = flatten_with_paths(out[0][1])
    got = flatten_with_paths(jax.tree.map(np.asarray, back["params"]))
    assert got[0] == paths
    for pth, x, y in zip(paths, leaves, got[1]):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=pth)


# -- placements ----------------------------------------------------------------
def _documented(spec, shape, path, cfg, mesh):
    """The reference's placement of one leaf turned into the port's by
    the differences of contract (ROADMAP.md section 3): an entry whose
    axes do not divide its dimension is replicated; a recurrent mixer's
    leaves replicate where its heads do not divide the model axis;
    Mamba2's packed dimensions (``in_proj``, ``conv_w``, ``conv_b``)
    hold each rank's heads' parts with ``B``/``C`` whole."""
    tp = mesh.shape["model"]
    keys = path.split("/")
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim if s.kind == "mamba2" else cfg.num_heads
    if len(keys) > 1 and keys[-2] in ("mamba", "mix"):
        if H % tp:
            return (None,) * len(spec)
        xbc = ((di, True), (2 * s.state_dim, False))
        if keys[-1] == "in_proj":
            return spec[:-1] + (SH.Packed("model", ((di, True),) + xbc
                                          + ((H, True),)),)
        if keys[-1] in ("conv_w", "conv_b"):
            return spec[:-1] + (SH.Packed("model", xbc),)
    return tuple(None if e is not None and n % mesh.axis_size(
        (e,) if isinstance(e, str) else e) else e
        for e, n in zip(spec, shape))


PLACE = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,shape", PLACE, ids=_ids(PLACE))
def test_state_placements_match_reference(arch, shape):
    cfg = get_config(arch).reduced()
    mesh, jmesh = _meshes(shape)
    jcfg = jget_config(arch).reduced()
    rules = STEPS.rules_for(cfg, mesh)
    assert rules == JSTEPS.rules_for(jcfg, jmesh)
    jshapes, jaxes = jbuild_model(jcfg).param_specs()
    jp = _axes_leaves(_jspecs(JSH.param_shardings(jaxes, jmesh, rules)))
    shapes = {"/".join(str(k.key) for k in p): tuple(s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = _axes_leaves(STEPS.param_placements(build_model(cfg), mesh))
    assert got == {p: _documented(s, shapes[p], p, cfg, mesh)
                   for p, s in jp.items()}
    if cfg.ssm.kind == "mamba2" and cfg.family == "ssm":
        return
    st = build_model(cfg).decode_state_specs(4, 64, num_blocks=16,
                                             dp_groups=shape[0])
    jst = jbuild_model(jcfg).decode_state_specs(4, 64, num_blocks=16,
                                                dp_groups=shape[0])
    gs = _state_leaves(STEPS.state_shardings(mesh, st, cfg))
    ws = _state_leaves(JSTEPS.state_shardings(jmesh, jst, jcfg))
    if "conv" in ws and ws["ssd"][3] == "model":
        # the conv state holds the rank's channels (the reference
        # replicates it over model)
        s = cfg.ssm
        ws["conv"] = ws["conv"][:-1] + (SH.Packed("model", (
            (s.expand * cfg.d_model, True), (2 * s.state_dim, False))),)
    assert gs == ws


# -- serving ---------------------------------------------------------------------
SB, SS, STEPS_N, MAX_SEQ, NB, DP = 4, 16, 4, 32, 16, 2
SERVE = [(a, m) for a in ("rwkv6_7b", "zamba2_2p7b")
         for m in [(1, 2), (1, 4), (2, 2)]]


def _tables():
    rng = np.random.default_rng(3)
    t = np.zeros((SB, MAX_SEQ // 8), np.int32)
    for g in range(DP):
        t[2 * g:2 * g + 2] = rng.permutation(NB // DP).reshape(2, -1)
    return t


def _inputs(vocab):
    rng = np.random.default_rng(11)
    toks = rng.integers(2, vocab, (SB, SS)).astype(np.int32)
    return toks, np.asarray([SS, 11, 7, SS], np.int32)


@functools.lru_cache(maxsize=None)
def _serve_reference(arch):
    """(converted weights, the reference's logits of the prefill and each
    decode step (5, B, V), the tokens it fed)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks, lens = _inputs(cfg.vocab_size)
    if cfg.family == "hybrid":
        st = jm.init_state(SB, MAX_SEQ, NB, DP)
        st = dataclasses.replace(st, kv=dataclasses.replace(
            st.kv, block_tables=jnp.asarray(_tables())))
    else:
        st = jm.init_state(SB)
    last, st = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, st,
                          jnp.asarray(lens))
    out, fed = [np.asarray(last)], []
    for _ in range(STEPS_N):
        nxt = out[-1].argmax(-1).astype(np.int32)
        fed.append(nxt)
        lg, st = jm.decode_step(jp, jnp.asarray(nxt), st)
        out.append(np.asarray(lg))
    return tp, np.stack(out), fed


def _global_state(model):
    if model.cfg.family == "hybrid":
        st = model.init_state(SB, MAX_SEQ, NB, DP, device="cpu")
        st.kv.block_tables.copy_(torch.as_tensor(_tables()))
        return st
    return model.init_state(SB, device="cpu")


def _serve_run(model, tp, feed, shape):
    """Every rank's gathered logits (5, B, V), its collective calls and
    the widths of its state's pieces."""
    cfg = model.cfg
    toks, lens = _inputs(cfg.vocab_size)

    def fn(mesh):
        glob = _global_state(model)
        prefill = STEPS.build_prefill_step(model, mesh=mesh,
                                           state_example=glob)
        serve = STEPS.build_serve_step(model, mesh=mesh, state_example=glob)
        params = STEPS.shard_params(mesh, tp, serve.in_shardings)
        state = STEPS.shard_state(mesh, glob, cfg)
        rows = STEPS.shard_batch(mesh, {"t": toks, "l": lens})
        last, state = prefill(params, torch.as_tensor(rows["t"]), state,
                              torch.as_tensor(rows["l"]))
        out = [last]
        for f in feed:
            mine = STEPS.shard_batch(mesh, {"f": f})["f"]
            lg, state = serve(params, torch.as_tensor(mine), state)
            out.append(lg)
        got = torch.stack([STEPS.gather_logits(mesh, o, cfg.vocab_size)
                           for o in out])
        shapes = {f: tuple(getattr(state, f).shape) for f in
                  ("mix_x", "wkv", "conv", "ssd") if hasattr(state, f)}
        return got.numpy(), dict(mesh.stats.calls), shapes

    return run_ranks(shape, fn, device="cpu")


@pytest.mark.parametrize("arch,shape", SERVE, ids=_ids(SERVE))
def test_state_tp_serve_matches_one_device_reference(arch, shape):
    tp, ref, fed = _serve_reference(arch)
    cfg = get_config(arch).reduced()
    res = _serve_run(build_model(cfg), tp, fed, shape)
    got = res[0][0]
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], got)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    assert res[0][1]["all_reduce"] > 0          # row-parallel sums, norms
    tpn, rows = shape[1], SB // shape[0]
    s = cfg.ssm
    if cfg.family == "hybrid":
        di = s.expand * cfg.d_model
        H = di // s.head_dim
        assert res[0][2]["conv"][-1] == di // tpn + 2 * s.state_dim
        assert res[0][2]["ssd"][2:4] == (rows, H // tpn)
    else:
        assert res[0][2]["wkv"][1:3] == (rows, cfg.num_heads // tpn)
        assert res[0][2]["mix_x"][1:] == (rows, cfg.d_model)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_mamba2_mesh_serving_refuses_its_state(shape):
    """The reference's ``state_shardings`` has no ``Mamba2State`` case:
    its mesh serve and prefill steps raise ``TypeError`` on a state of
    Mamba2's, on a model axis as on a data one."""
    model = build_model(get_config("mamba2_370m").reduced())
    glob = model.init_state(2, device="cpu")
    for build in (STEPS.build_serve_step, STEPS.build_prefill_step):
        with pytest.raises(TypeError, match="Mamba2State"):
            run_ranks(shape, lambda m: build(model, mesh=m,
                                             state_example=glob),
                      timeout=2.0, device="cpu")


# -- planted faults -----------------------------------------------------------
def test_planted_fault_norm_without_its_model_sum(monkeypatch):
    """``ln_x`` with each rank's own sum of squares (the model axis's sum
    left out): the step must fall outside the limit the real one meets."""
    np_params, batch, loss, gnorm, want = _reference("rwkv6_7b")
    monkeypatch.setattr(SH, "model_sum_squares", lambda x: (
        x.float() * x.float()).sum(dim=-1, keepdim=True))
    out = _mesh_step(get_config("rwkv6_7b").reduced(), np_params, batch,
                     (1, 2))
    assert abs(out[0][0] - loss) > 100 * TOL * abs(loss)
    assert max(_leaf_gaps(out[0][2], want).values()) > 100 * TOL


def test_planted_fault_per_head_leaf_left_unsummed(monkeypatch):
    """Mamba2's ``D`` is whole on every rank and each uses its heads'
    entries: its gradient share left unsummed over ``model`` must put
    the step outside the limit (the forward is intact)."""
    np_params, batch, loss, gnorm, want = _reference("mamba2_370m")
    real = STEPS._sum_grads

    def faulty(mesh, grads, pshard, **kw):
        g = grads["layers"]["mamba"]["D"]
        share = g.clone()
        real(mesh, grads, pshard, **kw)
        g.copy_(share)

    monkeypatch.setattr(STEPS, "_sum_grads", faulty)
    out = _mesh_step(get_config("mamba2_370m").reduced(), np_params, batch,
                     (1, 2))
    np.testing.assert_allclose(out[0][0], loss, rtol=TOL)
    gaps = _leaf_gaps(out[0][2], want)
    assert gaps["layers/mamba/D"] > 100 * TOL
    assert abs(out[0][1] - gnorm) > TOL * gnorm


# -- the launcher ---------------------------------------------------------------
def test_launcher_model_parallel_rwkv6_on_two_processes(tmp_path):
    """``--arch rwkv6_7b --reduced --model-parallel 2`` on two processes
    (gloo on the CPU, sequence parallelism on): 3 steps whose losses
    equal the one-process launcher's within 1e-5."""
    argv = ["--arch", "rwkv6_7b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3",
            "--ckpt-every", "0", "--log-every", "1"]
    one = train_main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    procs = spawn_processes(
        2, ["-m", "repro_torch.launch.train", *argv, "--model-parallel", "2",
            "--ckpt-dir", str(tmp_path / "two")], timeout=10.0,
        deadline=60.0)
    assert [p.returncode for p in procs] == [0, 0], procs[0].stderr[-2000:]
    two = [float(x) for x in re.findall(r"\] loss=([0-9.]+)", procs[0].stdout)]
    assert len(two) == 3
    np.testing.assert_allclose(two, one, rtol=TOL)
