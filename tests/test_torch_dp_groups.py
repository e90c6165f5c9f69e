"""Data-parallel pool groups (``dp_groups``) against the JAX package.

With ``dp_groups > 1`` a pool's block dim splits into contiguous group
ranges co-sharded with the batch and the tables hold group-local ids.
The port turns them into pool ids in one place
(``PagedKVCache.global_ids``) before any gather, scatter or kernel
launch; the reference batches its gathers and scatters per group.

* the grouped gather and scatter (``repro.models.attention.
  _grouped_gather``, ``repro.core.paged_kv.PagedKVCache._scatter_blocks``)
  against ``global_ids`` + plain indexing / ``write_prefill``;
* reduced ``gemma2_27b`` (local/global windows, softcaps) and
  ``minicpm3_4b`` (MLA latent pool) with ``dp_groups=2`` group-local
  tables: ``prefill`` then ``decode_step`` logits against the reference's
  one-device ``dp_groups=2`` run at 1e-4, and equal to the port's own
  ``dp_groups=1`` run over the same blocks with global ids; gemma2's
  ``prefill_suffix`` through group-local write tables too;
* the Arena's groups (``group_range``, per-group ``ArenaStats.groups``,
  the re-registration error), snapshots that carry the group count in
  both directions between the packages, ``slot_group`` /
  ``Scheduler.validate_fork`` / ``PoolGroupMismatchError``, and the
  engine's refusal of ``dp_groups > 1``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.mem import Arena as JArena
from repro.models.api import build_model as jbuild_model
from repro.models.attention import _grouped_gather
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.scheduler import slot_group as jslot_group
from repro_torch.configs.base import get_config
from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
from repro_torch.mem import Arena
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import (PoolGroupMismatchError, Scheduler,
                                         slot_group)

torch.set_num_threads(1)

ATOL = RTOL = 1e-4


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


# -- grouped gather / scatter ------------------------------------------------
def test_global_ids_equal_the_grouped_gather():
    rng = np.random.default_rng(0)
    B, MB, NB, BT, K, H = 4, 2, 8, 4, 2, 3
    pool = rng.normal(size=(NB, BT, K, H)).astype(np.float32)
    local = rng.integers(0, 4, (B, MB)).astype(np.int32)
    local[1, 1] = -1                                   # NULL stays NULL
    cfg = dataclasses.replace(
        build_model(get_config("gemma_2b").reduced()).kv_config(16),
        num_blocks=NB, dp_groups=2)
    cache = PagedKVCache(None, None, torch.as_tensor(local), None, cfg)
    glob = cache.global_ids(cache.block_tables).numpy()
    want = local.copy()
    want[2:] += 4
    want[1, 1] = -1
    np.testing.assert_array_equal(glob, want)
    got = torch.as_tensor(pool)[torch.as_tensor(glob).clamp(min=0).long()]
    ref = _grouped_gather(jnp.asarray(pool),
                          jnp.asarray(np.maximum(local, 0)), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_write_prefill_equals_the_grouped_scatter():
    rng = np.random.default_rng(1)
    tm = build_model(get_config("gemma_2b").reduced())
    jm = jbuild_model(jget_config("gemma_2b").reduced())
    B, S, NB = 4, 16, 8
    kw = dict(max_seq=16, num_blocks=NB, batch=B, dp_groups=2)
    tkv, jkv = tm.kv_config(**kw), jm.kv_config(**kw)
    tables = np.asarray([[0, 1], [2, -1], [3, 0], [1, 2]], np.int32)
    L = tkv.num_layers
    k = rng.normal(size=(L, B, S, tkv.kv_heads, tkv.head_dim)).astype(
        np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    tc = PagedKVCache.create(tkv, B, device="cpu")
    tc.block_tables.copy_(torch.as_tensor(tables))
    tc = tc.write_prefill(torch.as_tensor(k), torch.as_tensor(v),
                          torch.full((B,), S, dtype=torch.int32))
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tables))
    jc = jc.write_prefill(jnp.asarray(k), jnp.asarray(v),
                          jnp.full((B,), S, jnp.int32))
    np.testing.assert_array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(tc.v_pool.numpy(), np.asarray(jc.v_pool))


# -- models at dp_groups=2 -------------------------------------------------
def _pair(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


@pytest.fixture(scope="module", params=["gemma2_27b", "minicpm3_4b"])
def pair(request):
    return _pair(request.param)


B, PROMPT, STEPS, MAX_SEQ, NB = 4, 24, 8, 32, 16


def _local_tables(rng):
    """Group-local tables: rows 0-1 in group 0, rows 2-3 in group 1,
    each group's 8 blocks dealt out in a shuffled order."""
    tables = np.zeros((B, MAX_SEQ // 8), np.int32)
    for g in range(2):
        ids = rng.permutation(NB // 2)
        tables[2 * g:2 * g + 2] = ids.reshape(2, -1)
    return tables


def test_prefill_and_decode_at_two_groups_match(pair):
    jm, jp, tm, tp, cfg = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(
        np.int32)
    tables = _local_tables(rng)
    lens = np.asarray([PROMPT, PROMPT - 5, PROMPT - 9, PROMPT], np.int32)
    runs = {}
    for dp in (1, 2):
        kw = dict(max_seq=MAX_SEQ, num_blocks=NB, batch=B, dp_groups=dp)
        tkv = tm.kv_config(**kw)
        tc = PagedKVCache.create(tkv, B, device="cpu")
        grouped = dataclasses.replace(tc, config=dataclasses.replace(
            tkv, dp_groups=2))
        tbl = (tables if dp == 2 else
               grouped.global_ids(torch.as_tensor(tables)).numpy())
        tc.block_tables.copy_(torch.as_tensor(tbl))
        last, tc = tm.prefill(tp, torch.as_tensor(toks[:, :PROMPT]), tc,
                              torch.as_tensor(lens))
        logits = [last]
        for t in range(STEPS):
            lg, tc = tm.decode_step(tp, torch.as_tensor(toks[:, PROMPT + t]),
                                    tc)
            logits.append(lg)
        runs[dp] = (torch.stack(logits).numpy(), tc.k_pool.numpy())
    jkv = jm.kv_config(max_seq=MAX_SEQ, num_blocks=NB, batch=B, dp_groups=2)
    jc = dataclasses.replace(JCache.create(jkv, B),
                             block_tables=jnp.asarray(tables))
    last, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jc,
                          jnp.asarray(lens))
    jlogits = [np.asarray(last)]
    for t in range(STEPS):
        lg, jc = jm.decode_step(jp, jnp.asarray(toks[:, PROMPT + t]), jc)
        jlogits.append(np.asarray(lg))
    jlogits = np.stack(jlogits)
    _close(runs[2][0], jlogits)
    assert np.array_equal(runs[2][0].argmax(-1), jlogits.argmax(-1))
    _close(runs[2][1], jc.k_pool)
    np.testing.assert_array_equal(runs[2][0], runs[1][0])
    np.testing.assert_array_equal(runs[2][1], runs[1][1])


def test_prefill_suffix_through_group_local_tables():
    """Two rows per group; each group's second row suffix-prefills 8
    tokens after the group's first row's 16, through group-local block
    and write tables, against the reference's grouped scatter/gather."""
    jm, jp, tm, tp, cfg = _pair("gemma2_27b")
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    suffix = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    tables = _local_tables(rng)
    write = tables[:, 2:3].copy()
    lens = np.full(B, 24, np.int32)
    starts = np.full(B, 16, np.int32)
    out = {}
    for pkg in ("jax", "torch"):
        kw = dict(max_seq=MAX_SEQ, num_blocks=NB, batch=B, dp_groups=2)
        if pkg == "jax":
            c = dataclasses.replace(JCache.create(jm.kv_config(**kw), B),
                                    block_tables=jnp.asarray(tables))
            _, c = jm.prefill(jp, {"tokens": jnp.asarray(base)}, c,
                              jnp.full((B,), 16, jnp.int32))
            last, c = jm.prefill_suffix(jp, jnp.asarray(suffix), c,
                                        jnp.asarray(lens),
                                        jnp.asarray(starts),
                                        jnp.asarray(write))
            out[pkg] = (np.asarray(last), np.asarray(c.k_pool))
        else:
            c = PagedKVCache.create(tm.kv_config(**kw), B, device="cpu")
            c.block_tables.copy_(torch.as_tensor(tables))
            _, c = tm.prefill(tp, torch.as_tensor(base), c,
                              torch.full((B,), 16, dtype=torch.int32))
            last, c = tm.prefill_suffix(tp, torch.as_tensor(suffix), c,
                                        torch.as_tensor(lens),
                                        torch.as_tensor(starts),
                                        torch.as_tensor(write))
            out[pkg] = (last.numpy(), c.k_pool.numpy())
    _close(out["torch"][0], out["jax"][0])
    _close(out["torch"][1], out["jax"][1])


# -- the Arena, snapshots, scheduler, engine ----------------------------------
def test_arena_groups_and_stats():
    for A in (Arena, JArena):
        a = A()
        a.register_class("kvg", num_blocks=8, block_nbytes=16, dp_groups=2)
        st = a._cls("kvg")
        assert (st.group_range(0), st.group_range(1)) == ((0, 4), (4, 8))
        m = a.mapping("kvg", owner=0)
        m.ensure_capacity(3)
        assert a.stats()["kvg"].groups == [
            {"group": 0, "used": 3, "free": 1},
            {"group": 1, "used": 0, "free": 4}]
        with pytest.raises(ValueError, match="g4"):
            a.register_class("kvg", num_blocks=8, block_nbytes=16,
                             dp_groups=4)
        with pytest.raises(ValueError, match="dp_groups"):
            a.register_class("bad", num_blocks=2, block_nbytes=16,
                             dp_groups=3)
        m.free()
        a.assert_quiescent()
    mgr = PagedKVManager(build_model(get_config("gemma_2b").reduced(
    )).kv_config(32, num_blocks=8, batch=2, dp_groups=2))
    assert mgr.arena.stats()[mgr.pool_class].groups[1]["free"] == 4


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_snapshot_carries_the_group_count(tmp_path, writer, reader):
    a = JArena() if writer == "jax" else Arena()
    a.register_class("kvg", num_blocks=8, block_nbytes=16, dp_groups=2)
    m = a.mapping("kvg", owner=3)
    m.ensure_capacity(2)
    m.migrate("host")
    a.transfers.drain() if hasattr(a.transfers, "drain") else None
    path = str(tmp_path / "arena.npz")
    a.snapshot(path)
    b = JArena() if reader == "jax" else Arena()
    restored = b.restore(path)
    assert b._cls("kvg").dp_groups == 2
    assert restored[("kvg", 3)].placement == "host"
    assert len(b.stats()["kvg"].groups) == 2
    c = JArena() if reader == "jax" else Arena()
    c.register_class("kvg", num_blocks=8, block_nbytes=16, dp_groups=1)
    with pytest.raises(ValueError):
        c.restore(path)


def test_slot_group_and_fork_gate_match_reference():
    for slots, dp in ((4, 2), (8, 4), (6, 3), (4, 1)):
        assert [slot_group(s, slots, dp) for s in range(slots)] == \
            [jslot_group(s, slots, dp) for s in range(slots)]
    Scheduler.validate_fork(0, 1, 4, 2)
    Scheduler.validate_fork(0, 3, 4, 1)
    for parent, child in ((0, 2), (3, 0)):
        with pytest.raises(PoolGroupMismatchError, match="pool group"):
            Scheduler.validate_fork(parent, child, 4, 2)
        with pytest.raises(Exception):
            JScheduler.validate_fork(parent, child, 4, 2)


def test_engine_refuses_dp_groups():
    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="dp_groups"):
        Engine(model, params, slots=2, max_seq=32, num_blocks=8, eos_id=-1,
               dp_groups=2, device="cpu")
