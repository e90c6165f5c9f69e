"""The port's sequence mixers and SSM models against the JAX package.

Mamba2's SSD block and RWKV6's time mixing (``repro_torch.models.mamba2``
/ ``rwkv6``) on reduced configs, float32 on the CPU, with the JAX
parameters converted through numpy and the same numpy-seeded inputs:

* chunked against sequential (the port's own oracle and JAX's), a
  streaming continuation (chunked prefix, then single steps), channels
  of near-total decay, and chunk sizes 4, 8 and 16 -- each case also
  held against the JAX function on the same inputs;
* a right-padded batch with per-row lengths ends each row's state at
  its own length (against single steps and against JAX);
* the reduced ``mamba2_370m``, ``rwkv6_7b`` and ``zamba2_2p7b`` models:
  ``state_to_rows`` after a prefill of mixed lengths equals JAX's rows;
* the converted parameters and the port's own ``init`` keep every leaf
  in the dtype the JAX model keeps it in (bfloat16, with the reference's
  float32 leaves).

Port against JAX: TOL = 1e-4 absolute and relative (float32 rounding of
differently ordered sums; observed ~1e-6).  Chunked against sequential:
the JAX package's own test tolerances (atol 3e-4, rtol 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.core.paged_kv import PagedKVManager as JManager
from repro.models import mamba2 as JM2
from repro.models import rwkv6 as JR6
from repro.models.api import build_model as jbuild_model
from repro.models.zamba2 import ZambaState as JZambaState
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as R6
from repro_torch.models.api import build_model
from repro_torch.models.convert import FLOAT32_LEAVES, convert_params
from repro_torch.models.zamba2 import ZambaState

torch.set_num_threads(1)

TOL = 1e-4
SEQ_ATOL, SEQ_RTOL = 3e-4, 1e-3
SSM_ARCHS = ["mamba2_370m", "rwkv6_7b", "zamba2_2p7b"]

#: mixer -> (config it is reduced from, JAX module, port module, names of
#: init / chunked forward / single step / sequential oracle)
MIXERS = {
    "mamba2": ("zamba2_2p7b", JM2, M2,
               ("init_mamba2", "mamba2_fwd", "mamba2_step", "mamba2_ref")),
    "rwkv6": ("rwkv6_7b", JR6, R6,
              ("init_rwkv6_mix", "rwkv6_mix_fwd", "rwkv6_mix_step",
               "rwkv6_mix_ref")),
}


def _close(got, want, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fast_decay(kind, jp):
    """Channels whose state decays by ~e^-20 a step: RWKV6's w0 = 3
    (log w = -exp(3)), Mamba2's A = -200 (dt up to 0.1)."""
    jp = dict(jp)
    if kind == "rwkv6":
        jp["w0"] = jnp.full_like(jp["w0"], 3.0)
    else:
        jp["A_log"] = jnp.full_like(jp["A_log"], np.log(200.0))
    return jp


class Mixer:
    """One mixer's JAX and port functions, parameters and inputs, and
    the JAX outputs the tests compare with (computed once)."""

    def __init__(self, kind, chunk=None, fast=False):
        arch, self.J, self.T, names = MIXERS[kind]
        self.kind = kind
        self.jcfg, self.cfg = jget_config(arch).reduced(), \
            get_config(arch).reduced()
        if chunk is not None:
            self.jcfg, self.cfg = (dataclasses.replace(
                c, ssm=dataclasses.replace(c.ssm, chunk=chunk))
                for c in (self.jcfg, self.cfg))
        self.init, self.fwd, self.step, self.ref = names
        jp = getattr(self.J, self.init)(jax.random.PRNGKey(0), self.jcfg)[0]
        self.jp = _fast_decay(kind, jp) if fast else jp
        self.tp = convert_params(_np(self.jp), self.cfg, device="cpu")
        rng = np.random.RandomState(0)
        self.x = rng.randn(3, 16, self.cfg.d_model).astype(np.float32)

    def jax(self, fn, x, *state, **kw):
        return getattr(self.J, fn)(self.jp, x, self.jcfg, *state, **kw)

    def port(self, fn, x, *state, **kw):
        return getattr(self.T, fn)(self.tp, x, self.cfg, *state, **kw)


@pytest.fixture(scope="module", params=sorted(MIXERS))
def mixer(request):
    m = Mixer(request.param)
    x = jnp.asarray(m.x)
    m.j_fwd = _np(m.jax(m.fwd, x))
    m.j_ref = np.asarray(m.jax(m.ref, x))
    y1, st = m.jax(m.fwd, x[:, :8])
    outs = [np.asarray(y1)]
    for t in range(8, 16):
        y, st = m.jax(m.step, x[:, t], *st)
        outs.append(np.asarray(y)[:, None])
    m.j_stream = np.concatenate(outs, 1)
    m.lens = np.array([16, 9, 3], np.int32)
    m.j_masked = _np(m.jax(m.fwd, x, lengths=jnp.asarray(m.lens)))
    return m


def test_chunked_matches_sequential_and_jax(mixer):
    x = torch.from_numpy(mixer.x)
    y, (a, b) = mixer.port(mixer.fwd, x)
    jy, (ja, jb) = mixer.j_fwd
    _close(y, jy)
    _close(a, ja)
    _close(b, jb)
    y_ref = mixer.port(mixer.ref, x)
    _close(y_ref, mixer.j_ref)
    _close(y, y_ref, SEQ_ATOL, SEQ_RTOL)


def test_streaming_continuation(mixer):
    """A chunked prefix, then one step per token: the same outputs as
    JAX's streaming run and as the sequential oracle."""
    x = torch.from_numpy(mixer.x)
    y1, st = mixer.port(mixer.fwd, x[:, :8])
    outs = [y1]
    for t in range(8, 16):
        y, st = mixer.port(mixer.step, x[:, t], *st)
        outs.append(y[:, None])
    got = torch.cat(outs, 1)
    _close(got, mixer.j_stream)
    _close(got, mixer.j_ref, SEQ_ATOL, SEQ_RTOL)


def test_padded_batch_ends_each_row_at_its_length(mixer):
    """Right padding masked by ``lengths``: each row's state equals the
    state after single steps over its own tokens only, and JAX's."""
    x = torch.from_numpy(mixer.x)
    lens = torch.from_numpy(mixer.lens)
    _, (a, b) = mixer.port(mixer.fwd, x, lengths=lens)
    _, (ja, jb) = mixer.j_masked
    _close(a, ja)
    _close(b, jb)
    for row, n in enumerate(mixer.lens):
        st = (torch.zeros_like(a[:1]), torch.zeros_like(b[:1]))
        for t in range(int(n)):
            _, st = mixer.port(mixer.step, x[row:row + 1, t], *st)
        _close(a[row], st[0][0], SEQ_ATOL, SEQ_RTOL)
        _close(b[row], st[1][0], SEQ_ATOL, SEQ_RTOL)


@pytest.fixture(scope="module", params=sorted(MIXERS))
def fast_mixer(request):
    m = Mixer(request.param, fast=True)
    x = jnp.asarray(m.x[:1])
    m.j_fwd = np.asarray(m.jax(m.fwd, x)[0])
    m.j_ref = np.asarray(m.jax(m.ref, x))
    return m


def test_fast_decay_stays_finite_and_exact(fast_mixer):
    """Per-step decay ~e^-20: the log-space chunked form stays finite
    and equal to the sequential oracle, as in JAX."""
    x = torch.from_numpy(fast_mixer.x[:1])
    y, _ = fast_mixer.port(fast_mixer.fwd, x)
    assert torch.isfinite(y).all()
    _close(y, fast_mixer.j_fwd)
    _close(y, fast_mixer.port(fast_mixer.ref, x), SEQ_ATOL, SEQ_RTOL)
    _close(y, fast_mixer.j_ref, SEQ_ATOL, SEQ_RTOL)


@pytest.fixture(scope="module",
                params=[(k, c) for k in sorted(MIXERS) for c in (4, 8, 16)],
                ids=lambda p: f"{p[0]}-chunk{p[1]}")
def chunked(request):
    kind, chunk = request.param
    m = Mixer(kind, chunk=chunk)
    x = jnp.asarray(m.x[:1])
    m.j_fwd = np.asarray(m.jax(m.fwd, x)[0])
    return m


def test_chunk_size_invariance(chunked):
    x = torch.from_numpy(chunked.x[:1])
    y, _ = chunked.port(chunked.fwd, x)
    _close(y, chunked.j_fwd)
    _close(y, chunked.port(chunked.ref, x), SEQ_ATOL, SEQ_RTOL)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def ssm_pair(arch, dtype=None):
    """(jax model, jax params, port model, port params, port cfg) on
    ``arch.reduced()`` (in ``dtype`` if given).  Zamba2's LoRA ``*_b``
    factors start at zero in both packages; they are drawn here so that
    each group's adapter changes its shared-attention weights."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if dtype is not None:
        jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    if "lora" in jp:
        rng = np.random.RandomState(7)
        lora = dict(jp["lora"])
        for nm in ("q_b", "k_b", "v_b"):
            lora[nm] = jnp.asarray(0.05 * rng.randn(*lora[nm].shape),
                                   lora[nm].dtype)
        jp = dict(jp, lora=lora)
    tp = convert_params(_np(jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


def states_after_prefill(pair, toks, lens):
    """Prefill ``toks`` (right-padded, ``lens`` valid) from zero state in
    both packages: ((jax last logits, jax state), (port ...)), each
    state as the model's own state object; Zamba2 writes its K/V into a
    fresh cache whose tables cover the batch."""
    jm, jp, tm, tp, cfg = pair
    B, S = toks.shape
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    if cfg.family == "hybrid":
        jkv = jm.kv_config(max_seq=S + 16, batch=B)
        mgr = JManager(jkv)
        tables = np.stack([(mgr.admit(i, S + 16), mgr.device_table(i))[1]
                           for i in range(B)])
        jc = dataclasses.replace(JCache.create(jkv, B),
                                 block_tables=jnp.asarray(tables))
        tc = PagedKVCache.create(tm.kv_config(max_seq=S + 16, batch=B), B,
                                 device="cpu")
        tc.block_tables.copy_(torch.from_numpy(tables))
        jconv, jssd = jm.init_recurrent(B)
        tconv, tssd = tm.init_recurrent(B, device="cpu")
        j = jm.prefill(jp, {"tokens": jt}, JZambaState(jconv, jssd, jc), jl)
        t = tm.prefill(tp, tt, ZambaState(tconv, tssd, tc), tl)
    else:
        j = jm.prefill(jp, {"tokens": jt}, jm.init_state(B), jl)
        t = tm.prefill(tp, tt, tm.init_state(B, device="cpu"), tl)
    return j, t


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_forward_logits_match_jax(arch):
    """``forward`` over 16 tokens from zero state: logits within TOL of
    JAX's at every position, the same greedy tokens."""
    jm, jp, tm, tp, cfg = ssm_pair(arch)
    toks = np.random.RandomState(2).randint(2, cfg.vocab_size, (2, 16))
    jl = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)})[0])
    tl = tm.forward(tp, torch.from_numpy(toks))[0]
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))


def rows_of(model, state):
    if isinstance(state, (ZambaState, JZambaState)):
        return model.state_to_rows(state.conv, state.ssd)
    return model.state_to_rows(state)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_state_rows_match_jax_after_mixed_prefill(arch):
    """One padded prefill of rows of 16, 11 and 5 tokens: the pool rows
    (``state_to_rows``, the layout swap and compaction move) equal JAX's
    element for element within TOL, and ``rows_to_state`` inverts
    ``state_to_rows`` exactly."""
    pair = ssm_pair(arch)
    jm, _, tm, _, cfg = pair
    toks = np.random.RandomState(3).randint(2, cfg.vocab_size, (3, 16))
    lens = np.array([16, 11, 5], np.int32)
    (jlast, jst), (tlast, tst) = states_after_prefill(pair, toks, lens)
    _close(tlast, jlast)
    jrows, trows = np.asarray(rows_of(jm, jst)), rows_of(tm, tst)
    assert trows.shape == (3, tm.state_elems) == jrows.shape
    assert trows.dtype == torch.float32
    _close(trows, jrows)
    back = tm.rows_to_state(trows)
    again = (tm.state_to_rows(*back) if isinstance(back, tuple)
             else tm.state_to_rows(back))
    assert torch.equal(again, trows)


def _dtype_tree(tree):
    if isinstance(tree, dict):
        return {k: _dtype_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_keep_the_reference_dtypes(arch):
    """In bfloat16, the converted tree and the port's own ``init`` hold
    every leaf at the JAX tree's shape and dtype: the reference's
    float32 leaves (Mamba2's conv_w, conv_b, A_log, dt_bias, D; RWKV6's
    w0, u) stay float32, the rest are bfloat16."""
    jm, jp, tm, tp, cfg = ssm_pair(arch, dtype="bfloat16")
    want = _dtype_tree(jp)
    assert _dtype_tree(tp) == want
    assert _dtype_tree(tm.init(seed=0, device="cpu")) == want
    f32 = {k for k, (_, dt) in _flat(want) if dt == "float32"}
    assert f32 and f32 <= FLOAT32_LEAVES


def _flat(tree, name=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, k)
    else:
        yield name, tree
