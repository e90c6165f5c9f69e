"""The port's mesh, sharding rules and placements against the JAX package.

Ranks are threads of this process over gloo, built by the package's own
runner (``repro_torch.launch.mesh.run_ranks``) over one in-process
``HashStore``: no subprocess, no default process group.

* the runner: coordinates, groups and collectives on (4, 1), (2, 1) and
  (2, 2, 1) meshes; a planted failing rank raises in the caller within
  the group timeout, every group is shut down, no thread is left, and a
  later run in the same process succeeds;
* ``param_specs``: shapes, dtypes and the logical-axes tree of every
  family, leaf for leaf against the reference's ``param_specs``;
* the rules and every placement (``param_shardings``, ``opt_shardings``
  with and without ZeRO-1, ``batch_shardings``, ``dp_groups_for``,
  ``state_shardings`` of every state type) against the reference's
  specs on a ``jax.sharding.AbstractMesh`` of the same shape (jax has
  one CPU device here), for a (2, 1), a (2, 2, 1) and a (2, 16) mesh;
* the pieces a rank holds: ``local_piece`` / ``gather_piece`` round
  trips, the batch's rows, and a paged cache's pool range and tables;
* the model axis: ``Mesh.all_to_all`` (pieces, statistics, a planted
  failing rank) and every placement over ``model`` of the served
  decoder LMs on (1, 2), (1, 3), (1, 4) and (2, 2) meshes against the
  reference's ``param_shardings`` and ``state_shardings``, with the
  documented differences applied by the test (``_documented``).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import jax
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jget_config
from repro.launch import shardings as JSH
from repro.launch import steps as JSTEPS
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import CONFIG_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import Mesh, batch_axes, run_ranks
from repro_torch.models.api import build_model
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

ARCHS = list(CONFIG_IDS)


# -- the runner --------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 1), (2, 1), (2, 2, 1)])
def test_runner_builds_groups_and_collectives(shape):
    def fn(mesh):
        bax = batch_axes(mesh)
        t = torch.full((3,), float(mesh.rank))
        mesh.all_reduce(t, bax)
        g = mesh.all_gather(torch.tensor([mesh.rank]), bax)
        b = torch.tensor([float(mesh.rank)])
        mesh.broadcast(b, src=0)
        return (mesh.coords, mesh.axis_index(bax), t.tolist(),
                g.reshape(-1).tolist(), float(b), mesh.group_ranks("data"),
                mesh.stats.calls["all_reduce"])

    out = run_ranks(shape, fn, device="cpu")
    n = int(np.prod(shape))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    for r, (coords, bidx, red, gath, bc, data_ranks, calls) in enumerate(out):
        want = dict(zip(names, np.unravel_index(r, shape)))
        assert coords == {k: int(v) for k, v in want.items()}
        assert bidx == r                  # model is 1: rank order = batch order
        assert red == [float(sum(range(n)))] * 3
        assert gath == list(range(n))
        assert bc == 0.0
        d = shape[-2]
        assert data_ranks == tuple(range(r - r % d, r - r % d + d))
        assert calls == 1


def test_runner_planted_failure_raises_and_cleans_up():
    before = threading.active_count()

    def fn(mesh):
        if mesh.rank == 1:
            raise ValueError("planted failure on rank 1")
        mesh.all_reduce(torch.zeros(4), "data")   # the peer never comes
        return "unreachable"

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="planted failure on rank 1"):
        run_ranks((2, 1), fn, timeout=2.0, device="cpu")
    assert time.monotonic() - t0 < 2.0 + 5.0
    assert threading.active_count() == before
    # the process stays usable: a later run succeeds
    assert run_ranks((2, 1), lambda m: m.rank * 10, device="cpu") == [0, 10]


def test_runner_deadline_raises_after_cleanup():
    before = threading.active_count()

    def fn(mesh):
        if mesh.rank == 0:
            time.sleep(1.0)                # past the deadline, no collective
        return mesh.rank

    with pytest.raises(TimeoutError, match="mesh-rank-0"):
        run_ranks((2, 1), fn, timeout=2.0, deadline=0.2, device="cpu")
    assert threading.active_count() == before


def test_runner_limits_and_backend_rules():
    with pytest.raises(ValueError, match="at most"):
        run_ranks((2, 1), lambda m: None, timeout=30.0, device="cpu")
    with pytest.raises(ValueError):
        run_ranks((2, 1), lambda m: None, backend="nccl", device="cpu")
    # one rank more than there are cards: two would share one, refused
    # before anything is built
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="one card per rank"):
        run_ranks((n, 1), lambda m: None, backend="nccl", device="cuda")
    (line,) = run_ranks((1, 1), lambda m: m.describe(), device="cpu")
    assert "gloo" in line and "no staging" in line
    m = Mesh(("data", "model"), (1, 1), 0, backend=None, device="cpu")
    t = torch.ones(2)
    assert m.all_reduce(t, "data") is t and m.all_gather(t, "data").shape \
        == (1, 2)


# -- param_specs -----------------------------------------------------------------
def _axes_leaves(tree):
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = tuple(node)
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    jm = jbuild_model(jget_config(arch).reduced())
    jshapes, jaxes = jm.param_specs()
    shapes, axes = build_model(get_config(arch).reduced()).param_specs()
    assert _axes_leaves(axes) == _axes_leaves(jaxes)
    paths, leaves, _ = flatten_with_paths(shapes)
    jflat = {"/".join(str(k.key) for k in p): s for p, s in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert set(paths) == set(jflat)
    for p, t in zip(paths, leaves):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jflat[p].shape), p
        assert str(t.dtype).split(".")[-1] == str(jflat[p].dtype), p


# -- rules and placements ----------------------------------------------------
MESHES = [(2, 1), (2, 2, 1), (2, 16)]


def _meshes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return (Mesh(names, shape, 0, backend=None, device="cpu"),
            AbstractMesh(shape, names))


def _spec(ns):
    return tuple(ns.spec)


def _jspecs(tree):
    return jax.tree.map(_spec, tree,
                        is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_param_placements_match_reference(arch, shape):
    mesh, jmesh = _meshes(shape)
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rules = STEPS.rules_for(cfg, mesh)
    assert rules == JSTEPS.rules_for(jcfg, jmesh)
    jshapes, jaxes = jbuild_model(jcfg).param_specs()
    shapes, axes = build_model(cfg).param_specs()
    pshard = SH.param_shardings(axes, mesh, rules)
    jpshard = JSH.param_shardings(jaxes, jmesh, rules)
    assert _axes_leaves(pshard) == _axes_leaves(_jspecs(jpshard))
    for zero1 in (False, True):
        osh = STEPS.opt_shardings(mesh, pshard, shapes, zero1=zero1)
        josh = JSTEPS.opt_shardings(jmesh, jpshard, jshapes, zero1=zero1)
        assert osh.step == _spec(josh.step)
        assert _axes_leaves(osh.mu) == _axes_leaves(_jspecs(josh.mu))
        assert _axes_leaves(osh.nu) == _axes_leaves(_jspecs(josh.nu))


def test_rule_context_is_per_thread():
    mesh, _ = _meshes((2, 16))
    assert SH.active_mesh() is None and SH.tp_size() == 1
    seen = []
    with SH.use_rules(mesh, {"vocab": None}):
        assert SH.active_mesh() is mesh and SH.tp_size() == 16
        assert SH.spec_for(("batch", "vocab", "heads")) == (
            "data", None, "model")
        assert SH.use_ctx_parallel(32) is False
        assert SH.use_ctx_parallel(6) is True
        t = threading.Thread(target=lambda: seen.append(SH.active_mesh()))
        t.start()
        t.join()
    assert seen == [None] and SH.active_mesh() is None


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("B", [4, 3])
def test_batch_placements_match_reference(shape, B):
    mesh, jmesh = _meshes(shape)
    specs = {"tokens": np.zeros((B, 16), np.int32),
             "targets": np.zeros((B, 16), np.int32),
             "frames": np.zeros((B, 4, 8), np.float32)}
    got = STEPS.batch_shardings(mesh, specs, B)
    want = JSTEPS.batch_shardings(jmesh, specs, B)
    assert got == {k: _spec(v) for k, v in want.items()}
    assert STEPS.dp_groups_for(mesh, B) == JSTEPS.dp_groups_for(jmesh, B)


def _state_leaves(state):
    """Placement tuples or spec tuples of a decode state, by field."""
    out = {}
    for f in ("k_pool", "v_pool", "block_tables", "seq_lens", "mix_x",
              "ffn_x", "wkv", "conv", "ssd", "cross_k", "cross_v"):
        if hasattr(state, f):
            v = getattr(state, f)
            out[f] = None if v is None else (
                tuple(v.spec) if hasattr(v, "spec") else tuple(v))
    for sub in ("kv", "self_kv"):
        if hasattr(state, sub):
            out[sub] = _state_leaves(getattr(state, sub))
    return out


@pytest.mark.parametrize("shape", [(2, 1), (2, 2, 1)])
@pytest.mark.parametrize("arch", ["gemma2_27b", "minicpm3_4b", "rwkv6_7b",
                                  "zamba2_2p7b", "whisper_tiny"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_state_placements_match_reference(arch, shape, dp):
    mesh, jmesh = _meshes(shape)
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    B, S = 4, 64
    nb = 8 * dp
    jst = jbuild_model(jcfg).decode_state_specs(B, S, num_blocks=nb,
                                                dp_groups=dp)
    st = build_model(cfg).decode_state_specs(B, S, num_blocks=nb,
                                             dp_groups=dp)
    got = STEPS.state_shardings(mesh, st, cfg)
    want = JSTEPS.state_shardings(jmesh, jst, jcfg)
    assert _state_leaves(got) == _state_leaves(want)


def test_mamba2_state_has_no_placement():
    mesh, jmesh = _meshes((2, 1))
    cfg = get_config("mamba2_370m").reduced()
    st = build_model(cfg).decode_state_specs(4, 64)
    with pytest.raises(TypeError):
        STEPS.state_shardings(mesh, st, cfg)
    jcfg = jget_config("mamba2_370m").reduced()
    with pytest.raises(TypeError):
        JSTEPS.state_shardings(jmesh, jbuild_model(jcfg).decode_state_specs(
            4, 64), jcfg)


# -- pieces ----------------------------------------------------------------------
def test_pieces_round_trip_over_ranks():
    full = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = (("pod", "data"), None, "model")

    def fn(mesh):
        piece = SH.local_piece(mesh, full, spec)
        back = SH.gather_piece(mesh, piece.contiguous(), spec)
        rows = STEPS.shard_batch(mesh, {"tokens": np.arange(8)})["tokens"]
        return piece.shape, torch.equal(back, full), rows.tolist()

    out = run_ranks((2, 2, 1), fn, device="cpu")
    for r, (pshape, same, rows) in enumerate(out):
        assert pshape == (2, 6, 4) and same
        assert rows == [2 * r, 2 * r + 1]


def test_paged_cache_piece_holds_its_group_range():
    cfg = get_config("gemma2_27b").reduced()
    model = build_model(cfg)
    B, dp = 4, 2
    kvc = model.kv_config(64, num_blocks=8, batch=B, dp_groups=dp)
    from repro_torch.core.paged_kv import PagedKVCache
    cache = PagedKVCache.create(kvc, B, device="cpu")
    cache.k_pool.copy_(torch.arange(cache.k_pool.numel(),
                                    dtype=torch.float32).view_as(
                                        cache.k_pool))
    cache.block_tables[:, :2] = torch.tensor([[0, 1], [2, 3], [0, 1],
                                              [2, 3]], dtype=torch.int32)

    def fn(mesh):
        local = STEPS.shard_state(mesh, cache, cfg)
        return (local.config.num_blocks, local.config.dp_groups,
                torch.equal(local.k_pool, cache.k_pool[:, 4 * mesh.rank:
                                                       4 * mesh.rank + 4]),
                local.block_tables[:, :2].tolist())

    for r, (nb, g, same, tbl) in enumerate(run_ranks((2, 1), fn, device="cpu")):
        assert (nb, g, same) == (4, 1, True)
        assert tbl == [[0, 1], [2, 3]]


# -- the model axis ----------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_all_to_all_exchanges_pieces(shape):
    def fn(mesh):
        n = mesh.shape["model"]
        t = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) \
            + 100 * mesh.rank
        return (mesh.axis_index("model"), mesh.group_ranks("model"),
                mesh.all_to_all(t, "model").tolist(), mesh.stats.to_dict())

    for r, (i, ranks, got, stats) in enumerate(run_ranks(shape, fn, device="cpu")):
        # piece j of position i's input lands at position j, slot i
        assert got == [[100 * src + 3 * i + c for c in range(3)]
                       for src in ranks]
        assert stats["calls"] == {"all_to_all": 1}
        assert stats["bytes"] == {"all_to_all": shape[1] * 3 * 4}


def test_all_to_all_planted_failure_raises_and_cleans_up():
    before = threading.active_count()

    def fn(mesh):
        if mesh.rank == 1:
            raise ValueError("planted failure on rank 1")
        return mesh.all_to_all(torch.zeros(2, 4), "model")

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="planted failure on rank 1"):
        run_ranks((1, 2), fn, timeout=2.0, device="cpu")
    assert time.monotonic() - t0 < 2.0 + 5.0
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="leading dim of 2"):
        run_ranks((1, 2), lambda m: m.all_to_all(torch.zeros(3), "model"), device="cpu")
    assert run_ranks((1, 2), lambda m: m.all_to_all(
        torch.ones(2, 1) * m.rank, "model").tolist(), device="cpu") == [[[0.0], [1.0]]] * 2


TP_ARCHS = ["gemma_2b", "gemma2_27b", "gemma3_27b", "qwen3_moe_30b_a3b",
            "deepseek_v2_lite_16b", "minicpm3_4b"]
TP_MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]


def _documented(spec, shape, path, cfg, mesh, ep):
    """The reference's placement of one leaf turned into the port's by
    the differences of contract (ROADMAP.md section 3):
    1. an entry whose axes do not divide its dimension is replicated
       (the reference's jit refuses it);
    2. GQA ``wk``/``wv`` whose KV heads do not divide the model axis:
       each rank holds the KV head its query heads read
       (``Shared("model", kv_heads)``) where the reference cuts the
       columns over ``model``;
    3. under ``ep`` the experts' stacked leaves are
       ``(None, "model", None, None)``, as ``_moe_ep_shardmap``'s
       ``wspec`` places them."""
    spec = tuple(None if e is not None and n % mesh.axis_size(
        (e,) if isinstance(e, str) else e) else e
        for e, n in zip(spec, shape))
    tp = mesh.shape["model"]
    keys = path.split("/")
    if keys[-1] in ("wk", "wv") and keys[-2] == "attn" and \
            cfg.attention == "gqa" and spec[-1] == "model" and \
            cfg.kv_heads % tp:
        spec = spec[:-1] + (SH.Shared("model", cfg.kv_heads),)
    if ep and keys[0] == "layers" and keys[-2] == "ff" and \
            keys[-1] in ("wi", "wg", "wo"):
        spec = (None, "model", None, None)
    return spec


# ep where the reduced MoE configs' 8 experts split over the model axis
TP_CASES = ([(a, s, "tp") for a in TP_ARCHS for s in TP_MESHES]
            + [(a, s, "ep") for a in ("qwen3_moe_30b_a3b",
                                      "deepseek_v2_lite_16b")
               for s in TP_MESHES if 8 % s[1] == 0])


@pytest.mark.parametrize("arch,shape,mode", TP_CASES, ids=[
    f"{a}-{s[0]}x{s[1]}-{m}" for a, s, m in TP_CASES])
def test_model_axis_placements_match_reference(arch, shape, mode):
    cfg = get_config(arch).reduced()
    if mode == "ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, parallel_mode="ep"))
    mesh, jmesh = _meshes(shape)
    jcfg = jget_config(arch).reduced()
    rules = STEPS.rules_for(cfg, mesh)
    assert rules == JSTEPS.rules_for(jcfg, jmesh)
    jshapes, jaxes = jbuild_model(jcfg).param_specs()
    jp = _axes_leaves(_jspecs(JSH.param_shardings(jaxes, jmesh, rules)))
    shapes = {"/".join(str(k.key) for k in p): tuple(s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = _axes_leaves(STEPS.param_placements(build_model(cfg), mesh))
    want = {p: _documented(s, shapes[p], p, cfg, mesh, mode == "ep")
            for p, s in jp.items()}
    assert got == want
    # the pool's KV heads follow wk: whole, split, or the one read
    st = build_model(cfg).decode_state_specs(4, 64, num_blocks=16,
                                             dp_groups=shape[0])
    jst = jbuild_model(jcfg).decode_state_specs(4, 64, num_blocks=16,
                                                dp_groups=shape[0])
    gs = _state_leaves(STEPS.state_shardings(mesh, st, cfg))
    ws = _state_leaves(JSTEPS.state_shardings(jmesh, jst, jcfg))
    if cfg.attention == "gqa":
        kv = STEPS.kv_head_entry(cfg, mesh)
        assert kv == got["layers/attn/wk"][-1]
        if isinstance(kv, SH.Shared):       # difference 2, in the pools
            for f in ("k_pool", "v_pool"):
                ws[f] = ws[f][:3] + (kv,) + ws[f][4:]
    assert gs == ws
