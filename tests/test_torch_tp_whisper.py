"""Whisper-tiny over the model axis of the mesh, against the JAX
package's one-device steps.

Ranks are threads of this process over gloo (``run_ranks(...,
device="cpu")``), each running its own backward pass.  Reduced float32
``whisper_tiny`` -- 2 encoder layers over 16 frames, 4 decoder layers,
4 heads over 4 KV heads of 32, a 256-wide MLP, a 512-token vocabulary,
no rope -- on meshes:

* (1, 2) and (1, 4): the encoder's, the self and the cross attention's
  heads, the MLP's hidden dim and the vocabulary split; three row-
  parallel sums a decoder layer (after the self attention, the cross
  attention and the MLP);
* (1, 3): nothing divides 3, so the weights replicate and the prompt's
  attention is context-parallel;
* (2, 2): the data axis beside the model axis.

Serving: a prefill of right-padded prompts and 4 decode steps, the
weights from ``param_placements`` + ``shard_params``, the state from
``shard_state`` (each rank's self-attention pool and cross K/V hold its
heads; the cross K/V is computed at prefill from the rank's ``wk``/``wv``
columns), the logits from ``gather_logits``, against the reference's
one-device ``prefill``/``decode_step`` within 1e-5 of max |logit| with
equal greedy tokens (the mesh is fed the reference's tokens).

Training: one train step from the reference's converted weights on a
batch of B 4, S 12 with frames (B, 16, d) (S divides 2, 3 and 4; the 16
frames divide 2 and 4, not 3, so at (1, 3) the encoder stays whole while
the decoder's tokens go in sequence pieces) against
``jax.value_and_grad(model.loss)`` + ``repro.optim.adamw`` (``eps`` 1,
``lr`` 1): loss and clip norm within 1e-5 relative, every gathered leaf
within 1e-5 of its max, equal bits on every rank; with sequence
parallelism off, with ``remat`` off, with a 511-token vocabulary (no
axis divides it, so it replicates as at the published 51865), ZeRO-1 on
(2, 2) bit for bit against the plain update, and the forward step.  Then
the placements against the reference's with the documented differences
and a planted fault (the cross attention's ``wo`` left unsummed over
the model axis), which must fail in the serve and the train steps.

The helpers take an arch and serve ``tests/test_torch_tp_vlm.py`` too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.launch import shardings as JSH
from repro.launch import steps as JSTEPS
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as JOPT
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as A
from repro_torch.models.api import build_model
from repro_torch.models.common import flash_attention
from repro_torch.models.convert import convert_params
from repro_torch.tree import flatten_with_paths
from test_torch_mesh import _axes_leaves, _jspecs, _meshes, _state_leaves
from test_torch_tp_train import OPT_CFG, TOL, _leaf_gaps, _mesh_step

torch.set_num_threads(1)

ARCH = "whisper_tiny"
MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]
B, S = 4, 12                   # train: S divides 2, 3 and 4
SB, SS, STEPS_N, MAX_SEQ = 4, 16, 4, 32
NB, DP = 16, 2                 # 2 pool groups of 8 blocks, 4 rows of 4
ODD_VOCAB = 511                # no model axis of 2, 3 or 4 divides it


def _ids(shapes):
    return [f"{m[0]}x{m[1]}" for m in shapes]


def _cfgs(arch, vocab=None):
    """(the reference's reduced config, the port's), the vocabulary
    replaced by ``vocab`` in both."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return jcfg, cfg


def _extra(cfg, rows, seed):
    """The batch's stub inputs: Whisper's frames (rows, F, d) or a VLM's
    image embeddings (rows, I, d), float32 from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"frames": (0.1 * rng.normal(size=(
            rows, cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)}
    return {"image_embeds": (0.1 * rng.normal(size=(
        rows, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)}


def _batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((b, s)) < 0.2] = -1
    targets[0, :s // 2] = -1              # rows hold different counts
    return {"tokens": toks[:, :-1], "targets": targets,
            **_extra(cfg, b, seed + 1)}


@functools.lru_cache(maxsize=None)
def train_reference(arch, s, vocab=None):
    """(numpy parameters, batch, loss, clip norm, the updated leaves) of
    one step of the reference on one device: ``jax.value_and_grad`` of
    its loss, then ``repro.optim.adamw.apply_updates``."""
    jcfg, _ = _cfgs(arch, vocab)
    jm = jbuild_model(jcfg)
    jp = jax.jit(lambda r: jm.init(r)[0])(jax.random.PRNGKey(0))
    batch = _batch(jcfg, B, s)
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


def check_train(arch, s, shape, *, vocab=None, **kw):
    """One mesh train step of ``arch`` on ``shape`` held to the
    reference; returns the ranks' results."""
    np_params, batch, loss, gnorm, want = train_reference(arch, s, vocab)
    out = _mesh_step(_cfgs(arch, vocab)[1], np_params, batch, shape, **kw)
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


def check_forward(arch, s, shape):
    """The mesh forward step's loss against the reference's, the
    weights untouched and no gradient recorded."""
    np_params, batch, loss, _, _ = train_reference(arch, s)
    cfg = _cfgs(arch)[1]
    model = build_model(cfg)

    def fn(mesh):
        whole = convert_params(np_params, cfg, device="cpu")
        step = STEPS.build_forward_step(model, mesh=mesh)
        p = STEPS.shard_params(mesh, whole, step.in_shardings, copy=True)
        before = [t.clone() for t in flatten_with_paths(p)[1]]
        got, _ = step(p, STEPS.shard_batch(mesh, batch))
        same = all(torch.equal(a, b) for a, b in
                   zip(before, flatten_with_paths(p)[1]))
        return float(got), not got.requires_grad, same

    out = run_ranks(shape, fn, device="cpu")
    for got, no_grad, same in out:
        assert got == out[0][0] and no_grad and same
    np.testing.assert_allclose(out[0][0], loss, rtol=TOL)


def check_zero1(arch, s):
    """ZeRO-1 on (2, 2) against the plain update, bit for bit."""
    np_params, batch, _, _, _ = train_reference(arch, s)
    cfg = _cfgs(arch)[1]
    plain = _mesh_step(cfg, np_params, batch, (2, 2))
    z = _mesh_step(cfg, np_params, batch, (2, 2), zero1=True)
    for (pl, pn, pp, po, _), (zl, zn, zp, zo, _) in zip(plain, z):
        assert (pl, pn) == (zl, zn)
        for a, b in zip(flatten_with_paths((pp, po))[1],
                        flatten_with_paths((zp, zo))[1]):
            assert torch.equal(a, b)


# -- serving ---------------------------------------------------------------
def _tables():
    """Group-local tables: each group's 8 blocks dealt to its 2 rows in
    a fixed shuffled order."""
    rng = np.random.default_rng(3)
    t = np.zeros((SB, MAX_SEQ // 8), np.int32)
    for g in range(DP):
        t[2 * g:2 * g + 2] = rng.permutation(NB // DP).reshape(2, -1)
    return t


def _serve_inputs(cfg):
    """Prompt tokens (B, SS), lengths (an image prefix's counted) and
    the stub inputs."""
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (SB, SS)).astype(np.int32)
    lens = np.asarray([SS, 11, 7, SS], np.int32) + cfg.num_image_tokens
    return toks, lens, _extra(cfg, SB, 12)


@functools.lru_cache(maxsize=None)
def serve_reference(arch, vocab=None):
    """(converted float32 weights, the reference's logits of the prefill
    and each decode step (5, B, V), the tokens it fed)."""
    jcfg, cfg = _cfgs(arch, vocab)
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks, lens, extra = _serve_inputs(cfg)
    tables = jnp.asarray(_tables())
    if cfg.encoder is not None:
        st = jm.init_state(SB, MAX_SEQ, NB, DP)
        st = dataclasses.replace(st, self_kv=dataclasses.replace(
            st.self_kv, block_tables=tables))
    else:
        st = dataclasses.replace(
            JCache.create(jm.kv_config(MAX_SEQ, NB, SB, dp_groups=DP), SB),
            block_tables=tables)
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    last, st = jm.prefill(jp, batch, st, jnp.asarray(lens))
    out, fed = [np.asarray(last)], []
    for _ in range(STEPS_N):
        nxt = out[-1].argmax(-1).astype(np.int32)
        fed.append(nxt)
        lg, st = jm.decode_step(jp, jnp.asarray(nxt), st)
        out.append(np.asarray(lg))
    return tp, np.stack(out), fed


def global_state(model):
    """The global decode state over ``_tables()``."""
    if model.cfg.encoder is not None:
        st = model.init_state(SB, MAX_SEQ, NB, DP, device="cpu")
        st.self_kv.block_tables.copy_(torch.as_tensor(_tables()))
        return st
    st = PagedKVCache.create(model.kv_config(MAX_SEQ, NB, SB, dp_groups=DP),
                             SB, device="cpu")
    st.block_tables.copy_(torch.as_tensor(_tables()))
    return st


def _state_shapes(state):
    pools = getattr(state, "self_kv", state)
    out = {"k_pool": tuple(pools.k_pool.shape)}
    if hasattr(state, "cross_k"):
        out["cross_k"] = tuple(state.cross_k.shape)
    return out


def serve_run(model, tp, feed, shape):
    """Every rank's gathered logits (5, B, V), its collective calls and
    the shapes of its state's pools and cross K/V."""
    cfg = model.cfg
    toks, lens, extra = _serve_inputs(cfg)

    def fn(mesh):
        glob = global_state(model)
        prefill = STEPS.build_prefill_step(model, mesh=mesh,
                                           state_example=glob)
        serve = STEPS.build_serve_step(model, mesh=mesh, state_example=glob)
        params = STEPS.shard_params(mesh, tp, serve.in_shardings)
        state = STEPS.shard_state(mesh, glob, cfg)
        rows = STEPS.shard_batch(mesh, {"t": toks, "l": lens, **extra})
        kw = {k: torch.as_tensor(rows[k]) for k in extra}
        last, state = prefill(params, torch.as_tensor(rows["t"]), state,
                              torch.as_tensor(rows["l"]), **kw)
        out = [last]
        for f in feed:
            mine = STEPS.shard_batch(mesh, {"f": f})["f"]
            lg, state = serve(params, torch.as_tensor(mine), state)
            out.append(lg)
        got = torch.stack([STEPS.gather_logits(mesh, o, cfg.vocab_size)
                           for o in out])
        return got.numpy(), dict(mesh.stats.calls), _state_shapes(state)

    return run_ranks(shape, fn, device="cpu")


def check_serve(arch, shape, vocab=None):
    """The mesh's prefill and decode steps against the reference's:
    every rank's gathered logits equal, within 1e-5 of max |logit|,
    greedy tokens equal.  Returns rank 0's (logits gap of max |logit|,
    collective calls, state shapes)."""
    tp, ref, fed = serve_reference(arch, vocab)
    model = build_model(_cfgs(arch, vocab)[1])
    res = serve_run(model, tp, fed, shape)
    got = res[0][0]
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], got)
    scale = float(np.abs(ref).max())
    gap = float(np.abs(got - ref).max()) / scale
    assert gap <= TOL, gap
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    return gap, res[0][1], res[0][2]


def check_placements(arch, shape):
    """Placements against the reference's ``param_shardings`` and
    ``state_shardings``, with the documented differences (ROADMAP.md
    section 3): an entry whose axes do not divide its dimension is
    replicated; ``wk``/``wv`` (and the pools) whose KV heads do not
    divide the axis hold the KV head the rank's query heads read
    (``Shared``)."""
    _, cfg = _cfgs(arch)
    mesh, jmesh = _meshes(shape)
    jcfg = jget_config(arch).reduced()
    rules = STEPS.rules_for(cfg, mesh)
    assert rules == JSTEPS.rules_for(jcfg, jmesh)
    jshapes, jaxes = jbuild_model(jcfg).param_specs()
    jp = _axes_leaves(_jspecs(JSH.param_shardings(jaxes, jmesh, rules)))
    shapes = {"/".join(str(k.key) for k in p): tuple(s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    kv = STEPS.kv_head_entry(cfg, mesh)

    def documented(spec, shape, path):
        spec = tuple(None if e is not None and n % mesh.axis_size(
            (e,) if isinstance(e, str) else e) else e
            for e, n in zip(spec, shape))
        if path.split("/")[-1] in ("wk", "wv") and spec[-1] == "model":
            spec = spec[:-1] + (kv,)
        return spec

    got = _axes_leaves(STEPS.param_placements(build_model(cfg), mesh))
    assert got == {p: documented(s, shapes[p], p) for p, s in jp.items()}
    st = build_model(cfg).decode_state_specs(4, 64, num_blocks=16,
                                             dp_groups=shape[0])
    jst = jbuild_model(jcfg).decode_state_specs(4, 64, num_blocks=16,
                                                dp_groups=shape[0])
    gs = _state_leaves(STEPS.state_shardings(mesh, st, cfg))
    ws = _state_leaves(JSTEPS.state_shardings(jmesh, jst, jcfg))
    if isinstance(kv, SH.Shared):                # in the pools too
        for f in ("k_pool", "v_pool"):
            ws[f] = ws[f][:3] + (kv,) + ws[f][4:]
    assert gs == ws
    return got, gs


# -- the planted fault -----------------------------------------------------
def _cross_unsummed(p, x, kv, cfg, *, positions, seq_parallel=False):
    """``attention.gqa_cross`` with ``wo``'s product left unsummed over
    the model axis: each rank keeps its own heads' part."""
    split = p["wq"].shape[-1] != cfg.num_heads * cfg.hd
    if seq_parallel and split:
        x = SH.seq_gather(x)
    q = A._heads(p, x, "wq", "q_norm", cfg, positions)
    o = flash_attention(q, *kv, causal=False, scale=cfg.query_scale)
    y = o.reshape(*x.shape[:2], -1) @ p["wo"]
    return SH.seq_piece(y, 1) if seq_parallel and split else y


# -- tests -----------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_whisper_tp_serve_matches_one_device_reference(shape):
    _, calls, shapes = check_serve(ARCH, shape)
    cfg = get_config(ARCH).reduced()
    L, F, hd = cfg.num_layers, cfg.encoder.num_frames, cfg.hd
    tpn, rows = shape[1], SB // shape[0]
    kvh = cfg.kv_heads // tpn if cfg.num_heads % tpn == 0 else cfg.kv_heads
    # each rank's pools and cross K/V hold its heads, its rows
    assert shapes["cross_k"] == (L, rows, F, kvh, hd)
    assert shapes["k_pool"][-2:] == (kvh, hd)
    # row-parallel sums where the heads split; else the context-parallel
    # prompt attention's gathers alone
    assert calls.get("all_reduce", 0) > 0 if kvh < cfg.kv_heads else \
        set(calls) == {"all_gather"}


def test_whisper_tp_serve_with_an_undivided_vocabulary():
    _, calls, _ = check_serve(ARCH, (1, 2), vocab=ODD_VOCAB)
    assert "all_gather" not in calls   # the logits are whole on each rank


@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_whisper_tp_train_step_matches_one_device_reference(shape):
    calls = check_train(ARCH, S, shape)[0][4]
    # sequence parallelism: gathers before the column-parallel products
    # (the encoder output once), reduce-scatters after
    assert calls["all_gather"] > 0
    if shape[1] != 3:
        assert calls["reduce_scatter"] > 0


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=_ids([(1, 2),
                                                            (1, 3)]))
def test_whisper_tp_train_step_without_sequence_parallelism(shape):
    calls = check_train(ARCH, S, shape, rules={"seq": None})[0][4]
    if shape[1] == 2:
        # plain Megatron: the row-parallel sums and their adjoints (at
        # (1, 3) the context-parallel gathers' adjoints reduce-scatter)
        assert "reduce_scatter" not in calls and calls["all_reduce"] > 0


def test_whisper_tp_train_step_without_remat():
    check_train(ARCH, S, (1, 4), remat=False)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=_ids([(1, 2),
                                                            (1, 4)]))
def test_whisper_tp_train_step_with_an_undivided_vocabulary(shape):
    check_train(ARCH, S, shape, vocab=ODD_VOCAB)


def test_whisper_tp_forward_step_gives_the_global_loss():
    check_forward(ARCH, S, (2, 2))


def test_whisper_tp_zero1_equals_the_plain_step_bitwise():
    check_zero1(ARCH, S)


@pytest.mark.parametrize("shape", MESHES, ids=_ids(MESHES))
def test_whisper_placements_match_reference(shape):
    got, gs = check_placements(ARCH, shape)
    split = shape[1] != 3
    for part in ("enc_layers/attn", "dec_layers/attn", "dec_layers/xattn"):
        assert got[f"{part}/wq"][-1] == ("model" if split else None)
        assert got[f"{part}/wk"][-1] == ("model" if split else None)
    assert gs["cross_k"][3] == gs["self_kv"]["k_pool"][3] == \
        ("model" if split else None)


def test_planted_fault_cross_attention_wo_unsummed_in_serving(monkeypatch):
    """The serve path with the cross attention's ``wo`` left unsummed:
    its logits must fall far outside the limit."""
    tp, ref, fed = serve_reference(ARCH)
    monkeypatch.setattr(A, "gqa_cross", _cross_unsummed)
    res = serve_run(build_model(get_config(ARCH).reduced()), tp, fed,
                    (1, 2))
    gap = float(np.abs(res[0][0] - ref).max()) / float(np.abs(ref).max())
    assert gap > 100 * TOL


def test_planted_fault_cross_attention_wo_unsummed_in_training(monkeypatch):
    np_params, batch, loss, gnorm, want = train_reference(ARCH, S)
    monkeypatch.setattr(A, "gqa_cross", _cross_unsummed)
    out = _mesh_step(get_config(ARCH).reduced(), np_params, batch, (1, 2))
    assert abs(out[0][0] - loss) > 100 * TOL * abs(loss)
    assert max(_leaf_gaps(out[0][2], want).values()) > 100 * TOL
