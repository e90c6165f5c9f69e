"""The port's Whisper encoder-decoder against the JAX package's.

Reduced ``whisper_tiny`` (float32: 2 encoder layers over 16 frames, 4
decoder layers, d 128, 4 heads of 32, no rope): parameters from the JAX
``init`` go through ``convert_params``; frames and tokens are drawn
with a seeded numpy generator and handed to both packages.  Logits are
held at ATOL = RTOL = 1e-4 (float32 reorderings) and greedy tokens must
be identical.  Covered: ``sinusoidal_positions``, ``encode``,
``forward``, ``prefill`` then ``decode_step`` (self attention appended
through the fused append kernel's plain version, cross attention over
the dense encoder K/V), a decode over a permuted block placement, the
registry's unserved audio row with ``ReadOnlySegment``, and the
launchers' refusals.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVManager as JManager
from repro.models.api import build_model as jbuild_model
from repro.models.common import sinusoidal_positions as jsinusoidal
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVManager
from repro_torch.mem import Arena
from repro_torch.models.api import build_model
from repro_torch.models.common import sinusoidal_positions
from repro_torch.models.convert import convert_params
from repro_torch.models.whisper import WhisperModel, WhisperState
from repro_torch.serve.arch import (ARCHITECTURES, CompositeStrategy,
                                    ReadOnlySegment, build_strategy,
                                    resolve)
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
B, S, S0 = 2, 24, 16
MAX_POS = 64


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config("whisper_tiny").reduced()
    cfg = get_config("whisper_tiny").reduced()
    jm = jbuild_model(jcfg, max_positions=MAX_POS)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(11)
    frames = (0.1 * rng.normal(size=(B, cfg.encoder.num_frames,
                                     cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tm = build_model(cfg, max_positions=MAX_POS)
    return jm, jp, tm, tp, cfg, frames, toks


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("num,dim", [(16, 128), (1500, 384), (5, 2)])
def test_sinusoidal_positions_match(num, dim):
    got = sinusoidal_positions(num, dim)
    assert got.dtype == torch.float32 and got.shape == (num, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsinusoidal(num, dim)),
                               rtol=0, atol=1e-7)


def test_model_and_tree(pair):
    jm, jp, tm, tp, cfg, _, _ = pair
    assert isinstance(tm, WhisperModel) and tm.max_positions == MAX_POS
    assert tp["pos"].shape == (MAX_POS, cfg.d_model)
    assert set(tp["dec_layers"]) == {"attn", "xattn", "ff", "ln1", "lnx",
                                     "ln2"}
    assert set(tp["enc_layers"]) == {"attn", "ff", "ln1", "ln2"}
    assert tp["enc_layers"]["ff"]["wi"].shape[0] == cfg.encoder.num_layers
    # the port's own init draws the same tree, shapes and dtypes
    mine, theirs = (flatten_with_paths(t) for t in (tm.init(0, device="cpu"),
                                                     tp))
    assert mine[0] == theirs[0]
    assert ([(t.shape, t.dtype) for t in mine[1]]
            == [(t.shape, t.dtype) for t in theirs[1]])


def test_encode_matches(pair):
    jm, jp, tm, tp, _, frames, _ = pair
    _close(tm.encode(tp, torch.as_tensor(frames)).numpy(),
           jm.encode(jp, jnp.asarray(frames)))


def test_forward_logits_match(pair):
    jm, jp, tm, tp, _, frames, toks = pair
    jl, _, _ = jm.forward(jp, {"frames": jnp.asarray(frames),
                               "tokens": jnp.asarray(toks)})
    tl = tm.forward(tp, torch.as_tensor(toks), frames=torch.as_tensor(frames))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl.numpy(), jl)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


def _jax_tables(kvcfg, nseq, tokens):
    mgr = JManager(kvcfg)
    return np.stack([(mgr.admit(i, tokens), mgr.device_table(i))[1]
                     for i in range(nseq)])


def _port_decode(tm, tp, frames, toks, tables, num_blocks=None):
    """Prefill S0 tokens over ``tables``, then decode the rest: (prefill
    logits, [decode logits], state)."""
    st = tm.init_state(B, max_seq=S, num_blocks=num_blocks, device="cpu")
    st.self_kv.block_tables.copy_(torch.as_tensor(tables))
    last, st = tm.prefill(tp, torch.as_tensor(toks[:, :S0]), st,
                          torch.full((B,), S0, dtype=torch.int32),
                          frames=torch.as_tensor(frames))
    steps = []
    for t in range(S0, S):
        lg, st = tm.decode_step(tp, torch.as_tensor(toks[:, t]), st)
        steps.append(lg)
    return last, steps, st


def test_prefill_then_decode_match(pair):
    """Prefill S0 tokens, then decode S0..S-1: every step's logits and
    greedy tokens, the cross K/V and the self-attention pools match the
    reference's ``prefill`` + ``decode_step`` over the same tables."""
    jm, jp, tm, tp, cfg, frames, toks = pair
    st = jm.init_state(B, max_seq=S)
    tables = _jax_tables(st.self_kv.config, B, S)
    st = dataclasses.replace(st, self_kv=dataclasses.replace(
        st.self_kv, block_tables=jnp.asarray(tables)))
    jlast, st = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                "tokens": jnp.asarray(toks[:, :S0])}, st,
                           jnp.full((B,), S0, jnp.int32))
    last, steps, tst = _port_decode(tm, tp, frames, toks, tables)
    _close(last.numpy(), jlast)
    assert isinstance(tst, WhisperState)
    F = cfg.encoder.num_frames
    assert tst.cross_k.shape == (cfg.num_layers, B, F, cfg.kv_heads, cfg.hd)
    for t, lg in zip(range(S0, S), steps):
        jl, st = jm.decode_step(jp, jnp.asarray(toks[:, t]), st)
        _close(lg.numpy(), jl)
        assert np.array_equal(lg.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))
    _close(tst.cross_k.numpy(), st.cross_k)
    _close(tst.cross_v.numpy(), st.cross_v)
    assert np.array_equal(tst.self_kv.seq_lens.numpy(),
                          np.asarray(st.self_kv.seq_lens))
    _close(tst.self_kv.k_pool.numpy(), st.self_kv.k_pool)
    _close(tst.self_kv.v_pool.numpy(), st.self_kv.v_pool)


def test_decode_matches_forward_over_permuted_blocks(pair):
    """Physical block placement does not change the logits: tables drawn
    from a permuted pool with spare blocks give the reference's full
    forward logits position by position."""
    jm, jp, tm, tp, cfg, frames, toks = pair
    jl, _, _ = jm.forward(jp, {"frames": jnp.asarray(frames),
                               "tokens": jnp.asarray(toks)})
    kv = tm.kv_config(max_seq=S, batch=B)
    nb = kv.num_blocks + 6
    perm = np.random.default_rng(5).permutation(nb)[:kv.num_blocks]
    tables = perm.reshape(B, kv.max_blocks_per_seq).astype(np.int32)
    last, steps, _ = _port_decode(tm, tp, frames, toks, tables,
                                  num_blocks=nb)
    _close(last.numpy(), jl[:, S0 - 1])
    for t, lg in zip(range(S0, S), steps):
        _close(lg.numpy(), jl[:, t])


def test_plain_model_is_the_kernel_path_on_cpu(pair):
    _, _, _, tp, cfg, frames, toks = pair
    plain = build_model(cfg, max_positions=MAX_POS, plain=True)
    tm = build_model(cfg, max_positions=MAX_POS)
    tables = PagedKVManager(tm.kv_config(max_seq=S, batch=B))
    tables = np.stack([(tables.admit(i, S), tables.device_table(i))[1]
                       for i in range(B)])
    a = _port_decode(tm, tp, frames, toks, tables)
    b = _port_decode(plain, tp, frames, toks, tables)
    for x, y in zip([a[0]] + a[1], [b[0]] + b[1]):
        assert torch.equal(x, y)


# -- registry ---------------------------------------------------------------
def test_audio_row_is_registered_and_unserved(pair):
    _, _, tm, _, _, _, _ = pair
    rows = {r.key: r for r in ARCHITECTURES}
    assert not rows["audio"].served
    assert rows["audio"].strategy is CompositeStrategy
    assert rows["audio"].pool_suffixes == ("kv", "xattn")
    assert resolve(tm) is rows["audio"]
    with pytest.raises(NotImplementedError, match="not servable"):
        build_strategy(tm, arena=Arena(), slots=2, max_seq=64,
                       num_blocks=16, device="cpu")


def test_readonly_segment_shares_and_refuses_writes():
    a = Arena()
    a.register_class("xattn", num_blocks=8, block_nbytes=64)
    seg = ReadOnlySegment(a, "xattn")
    ids = seg.deposit("enc", 3)            # encode writes once
    assert len(ids) == 3 and seg.block_ids("enc") == ids
    with pytest.raises(ValueError):
        seg.deposit("enc", 1)
    for beam in ("b0", "b1", "b2"):
        assert seg.share("enc", beam) == ids   # pure aliasing
        assert seg.block_ids(beam) == ids
    alloc = a.allocator("xattn")
    for b in ids:
        assert alloc.refcount(b) == 4      # segment + 3 beams, 0 copies
    with pytest.raises(TypeError, match="read-only"):
        seg.ensure_writable("enc", 0)
    for beam in ("b0", "b1", "b2"):
        seg.drop_reader(beam)
    for b in ids:
        assert alloc.refcount(b) == 1
    seg.release("enc")
    a.assert_quiescent()


def test_readonly_segment_migrates():
    """The segment relocates like any mapping: to the host (its blocks
    freed on the device, its residency counted on the host) and back to
    fresh blocks; a reader's alias of them outlives the release."""
    a = Arena()
    a.register_class("xattn", num_blocks=6, block_shape=(4,),
                     dtype=torch.float32)
    seg = ReadOnlySegment(a, "xattn")
    ids = seg.deposit("enc", 2)
    assert seg.migrate("enc", "host") == ids
    a.transfers.drain()
    assert a.num_used("xattn") == 0
    assert a.host_counts("xattn") == {"enc": 2}
    back = seg.migrate("enc", "device")
    a.transfers.drain()
    assert len(back) == 2 and a.num_used("xattn") == 2
    assert a.host_counts("xattn") == {}
    assert seg.block_ids("enc") == back
    assert seg.share("enc", "beam") == back
    seg.release("enc")
    assert a.num_used("xattn") == 2        # the reader holds the blocks
    seg.drop_reader("beam")
    a.assert_quiescent()


def test_launchers_refuse_whisper():
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    with pytest.raises(NotImplementedError, match="not servable"):
        serve_main(["--arch", "whisper_tiny", "--reduced", "--device", "cpu",
                    "--requests", "1"])
    with pytest.raises(NotImplementedError, match="frames"):
        train_main(["--arch", "whisper_tiny", "--reduced", "--device", "cpu",
                    "--steps", "1"])
