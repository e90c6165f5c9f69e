"""The mesh's serve and prefill steps at 2 thread ranks, against one device
and against the JAX package.

For reduced ``gemma2_27b`` (paged KV over ``dp_groups=2`` pools with
group-local tables), ``rwkv6_7b`` (the constant RWKV state) and
``zamba2_2p7b`` (recurrent state + ``dp_groups=2`` paged KV), float32 on
the CPU: a prefill of right-padded prompts then greedy decode steps.
Each rank holds its rows and its group's pool range
(``launch.steps.shard_state``) and runs ``build_prefill_step`` /
``build_serve_step`` on them; ``gather_rows`` puts the logits back
together.  They must agree with the port's one-device steps on the
global state within 1e-5 of max|logit| and with the reference's
one-device run (its grouped gathers) within 1e-4, with equal greedy
tokens.  A paged cache without dp groups is refused on a mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.models.api import build_model as jbuild_model
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params

torch.set_num_threads(1)

B, S, STEPS_N, MAX_SEQ = 4, 16, 4, 32
NB = 16                       # 8 blocks a group, 4 rows of 4 blocks


def _pair(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


def _tables():
    """Group-local tables: each group's 8 blocks dealt to its 2 rows in
    a fixed shuffled order."""
    rng = np.random.default_rng(3)
    t = np.zeros((B, MAX_SEQ // 8), np.int32)
    for g in range(2):
        t[2 * g:2 * g + 2] = rng.permutation(NB // 2).reshape(2, -1)
    return t


def _port_state(tm, cfg, tables):
    if cfg.family == "hybrid":
        st = tm.init_state(B, MAX_SEQ, NB, 2, device="cpu")
        st.kv.block_tables.copy_(torch.as_tensor(tables))
    elif cfg.ssm is not None:
        st = tm.init_state(B, device="cpu")
    else:
        st = PagedKVCache.create(tm.kv_config(MAX_SEQ, NB, B, dp_groups=2),
                                 B, device="cpu")
        st.block_tables.copy_(torch.as_tensor(tables))
    return st


def _jax_state(jm, cfg, tables):
    if cfg.family == "hybrid":
        st = jm.init_state(B, MAX_SEQ, NB, 2)
        return dataclasses.replace(st, kv=dataclasses.replace(
            st.kv, block_tables=jnp.asarray(tables)))
    if cfg.ssm is not None:
        return jm.init_state(B)
    return dataclasses.replace(
        JCache.create(jm.kv_config(MAX_SEQ, NB, B, dp_groups=2), B),
        block_tables=jnp.asarray(tables))


def _inputs(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([S, 11, 7, S], np.int32)
    return toks, lens


@pytest.fixture(scope="module",
                params=["gemma2_27b", "rwkv6_7b", "zamba2_2p7b"])
def pair(request):
    return _pair(request.param)


def _greedy(prefill, serve, tp, toks, lens, state):
    """Prefill then STEPS_N greedy steps: the logits of each, stacked."""
    last, state = prefill(tp, torch.as_tensor(toks), state,
                          torch.as_tensor(lens))
    out = [last]
    for _ in range(STEPS_N):
        nxt = out[-1].argmax(-1).to(torch.int32)
        lg, state = serve(tp, nxt, state)
        out.append(lg)
    return out


def test_mesh_serve_and_prefill_steps_match(pair):
    jm, jp, tm, tp, cfg = pair
    tables = _tables()
    toks, lens = _inputs(cfg)
    one = _greedy(STEPS.build_prefill_step(tm, device="cpu"),
                  STEPS.build_serve_step(tm, device="cpu"), tp, toks, lens,
                  _port_state(tm, cfg, tables))
    one = torch.stack(one).numpy()

    def fn(mesh):
        glob = _port_state(tm, cfg, tables)
        local = STEPS.shard_state(mesh, glob, cfg)
        prefill = STEPS.build_prefill_step(tm, mesh=mesh, state_example=glob)
        serve = STEPS.build_serve_step(tm, mesh=mesh, state_example=glob)
        rows = STEPS.shard_batch(mesh, {"t": toks, "l": lens})
        outs = _greedy(prefill, serve, tp, rows["t"], rows["l"], local)
        return torch.stack([STEPS.gather_rows(mesh, o) for o in outs]).numpy()

    got = run_ranks((2, 1), fn, device="cpu")
    np.testing.assert_array_equal(got[0], got[1])
    scale = float(np.abs(one).max())
    np.testing.assert_allclose(got[0], one, rtol=0, atol=1e-5 * scale)
    assert np.array_equal(got[0].argmax(-1), one.argmax(-1))

    st = _jax_state(jm, cfg, tables)
    last, st = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, st,
                          jnp.asarray(lens))
    ref = [np.asarray(last)]
    for _ in range(STEPS_N):
        lg, st = jm.decode_step(jp, jnp.asarray(ref[-1].argmax(-1),
                                                jnp.int32), st)
        ref.append(np.asarray(lg))
    np.testing.assert_allclose(got[0], np.stack(ref), rtol=1e-4, atol=1e-4)


def test_mesh_serve_step_refuses_an_ungrouped_pool():
    cfg = get_config("gemma_2b").reduced()
    tm = build_model(cfg)
    glob = PagedKVCache.create(tm.kv_config(MAX_SEQ, NB, B), B, device="cpu")

    def fn(mesh):
        STEPS.build_serve_step(tm, mesh=mesh, state_example=glob)

    with pytest.raises(ValueError, match="dp_groups = 2"):
        run_ranks((2, 1), fn, device="cpu")
    # the model axis serves (tests/test_torch_tp_serve.py) and trains
    # (tests/test_torch_tp_train.py): its forward step builds
    steps = run_ranks((1, 2), lambda m: STEPS.build_forward_step(tm, mesh=m),
                      device="cpu")
    assert all(s.mesh.shape == {"data": 1, "model": 2} for s in steps)
