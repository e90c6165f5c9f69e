"""Live migration, restart from an Arena snapshot and prefill/decode
disaggregation in the PyTorch package, against the JAX package.

Reduced float32 models on the CPU (gemma_2b from paged KV, mamba2_370m
from one state block per sequence, the zamba2_2p7b hybrid from both),
with the JAX parameters converted through numpy, ``slots=2``,
``max_seq=64`` and ``num_blocks=24`` as in ``tests/test_migration.py``.
Each workload runs through both packages on the same seeded requests:

* the allocator's write generation, the dirty-set convergence of a
  ``MigrationSession`` (its report equal to the JAX session's) and
  snapshot/restore with COW aliases, refcounts and tenants;
* ``migrate_live`` mid-decode (seeds 0-2), the disaggregated prefill and
  the restart through ``restore_preempted``, with the tokens of the
  port's unmigrated control and of the JAX engine;
* the snapshot schema: a float32 snapshot written by ``repro.mem.Arena``
  restores into the port (a reduced gemma_2b engine resumes to the JAX
  engine's tokens) and the port's into the reference; a bfloat16 pool
  round-trips bit for bit;
* the device token latch across a resume and an adopt, the adopt
  errors, ``release_arena`` and the engine's ``share_prefixes`` and
  ``prefetch`` options.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.mem import Arena as JArena
from repro.mem.migrate import MigrationSession as JMigrationSession
from repro.serve.disagg import (DisaggregatedEngine as JDisaggregatedEngine,
                                PrefillWorker as JPrefillWorker,
                                capture_request_plane as jcapture,
                                migrate_live as jmigrate_live)
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.mem import Arena, MigrationSession
from repro_torch.serve.disagg import (DisaggregatedEngine, PrefillWorker,
                                      migrate_live, resume_engine)
from repro_torch.serve.engine import Engine, Request
from test_torch_engine import make_pair
from test_torch_ssm import ssm_pair

torch.set_num_threads(1)

ENGINE_KW = dict(slots=2, max_seq=64, num_blocks=24, eos_id=-1,
                 prefill_budget=None)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return make_pair() if arch == "gemma_2b" else ssm_pair(arch)


@pytest.fixture(scope="module")
def gemma():
    return _pair("gemma_2b")


@pytest.fixture(scope="module", params=["mamba2_370m", "zamba2_2p7b"])
def state_arch(request):
    return request.param


def _engine(pkg, pair, **kw):
    jm, jp, tm, tp, _ = pair
    kw = {**ENGINE_KW, **kw}
    if pkg == "jax":
        return JEngine(jm, jp, **kw)
    return Engine(tm, tp, device="cpu", **kw)


def _req(pkg, **kw):
    return (JRequest if pkg == "jax" else Request)(**kw)


def _tokens(done):
    return {r.rid: list(r.generated) for r in done}


# ---------------------------------------------------------------------------
# the software dirty bit
# ---------------------------------------------------------------------------
def _write_gen_trace(pkg):
    if pkg == "jax":
        a = JArena()
        a.register_class("kv", num_blocks=8, block_shape=(4,),
                         dtype=jnp.float32)
    else:
        a = Arena()
        a.register_class("kv", num_blocks=8, block_shape=(4,),
                         dtype=torch.float32)
    alloc = a.allocator("kv")
    l1, l2 = a.lease_blocks("kv", "o", 2)
    g1, g2 = alloc.write_gen(l1.block), alloc.write_gen(l2.block)
    assert g1 > 0 and g2 > 0          # alloc itself dirties the block
    alloc.note_write([l1.block])
    assert alloc.write_gen(l1.block) == g1 + 1
    assert alloc.write_gen(l2.block) == g2      # neighbour untouched
    alloc.note_write([l1.block, l1.block])
    assert alloc.write_gen(l1.block) > g1 + 1
    got = alloc.write_gens([l1.block, l2.block])
    assert list(got) == [alloc.write_gen(l1.block), g2]
    l1.release()
    [l3] = a.lease_blocks("kv", "o", 1)         # reuse re-dirties the id
    return [alloc.write_gen(b) for b in range(8)], l3.block


def test_write_generation_counter():
    assert _write_gen_trace("torch") == _write_gen_trace("jax")


# ---------------------------------------------------------------------------
# dirty-set convergence, against the JAX session
# ---------------------------------------------------------------------------
def _converge(pkg, pair, path):
    eng = _engine(pkg, pair)
    rng = np.random.RandomState(3)
    for i in range(2):
        eng.submit(_req(pkg, rid=i, prompt=rng.randint(2, 500, size=12),
                        max_new=16))
    for _ in range(3):
        eng.step()
    sess = (JMigrationSession if pkg == "jax" else MigrationSession)(
        eng.arena, max_rounds=8)
    while not sess.converged():
        sess.begin_round()
        eng.step()
        sess.collect_round()
    stop = sess.finalize(path)
    return eng, stop, sess.migration_report()


def test_dirty_set_converges_to_working_set(gemma, tmp_path):
    """Pre-copy rounds shrink the dirty set to the decode working set
    (one tail block per running sequence); the port's rounds, bytes and
    stop-and-copy tail equal the JAX session's on the same workload."""
    eng, stop, rep = _converge("torch", gemma, str(tmp_path / "t.npz"))
    jeng, jstop, jrep = _converge("jax", gemma, str(tmp_path / "j.npz"))
    for key in ("rounds", "blocks_per_round", "bytes_per_round",
                "stop_copy_blocks", "stop_copy_bytes", "pause_steps"):
        assert rep[key] == jrep[key], (key, rep[key], jrep[key])
    assert stop == jstop
    assert rep["finalized"] and rep["rounds"] >= 2
    assert rep["blocks_per_round"][-1] < rep["blocks_per_round"][0]
    assert 0 < stop["blocks"] <= len(eng.running)
    assert stop["bytes"] == stop["blocks"] * eng.arena.block_nbytes(
        eng.strategy.mgr.pool_class)
    assert rep["pause_steps"] == 1
    eng.release_arena()
    jeng.release_arena()


# ---------------------------------------------------------------------------
# snapshot/restore with device payloads: aliasing + tenants survive
# ---------------------------------------------------------------------------
def _aliased_snapshot(pkg, pair, path):
    eng = _engine(pkg, pair, slots=3)
    rng = np.random.RandomState(11)
    base = rng.randint(2, 500, size=16)           # two full blocks
    eng.submit(_req(pkg, rid=0, prompt=base.copy(), max_new=12, tenant="a"))
    eng.step()
    eng.submit(_req(pkg, rid=1, prompt=np.concatenate(
        [base, rng.randint(2, 500, size=5)]), max_new=12, tenant="b"))
    eng.submit(_req(pkg, rid=2, prompt=rng.randint(2, 500, size=9),
                    max_new=12, tenant="a"))
    for _ in range(3):
        eng.step()
    eng.preempt_latest()
    eng.transfers.drain()
    eng.arena.snapshot(path, include_device=True)
    return eng


def test_snapshot_restore_preserves_cow_aliases_and_tenants(gemma, tmp_path):
    path = str(tmp_path / "snap.npz")
    eng = _aliased_snapshot("torch", gemma, path)
    jeng = _aliased_snapshot("jax", gemma, str(tmp_path / "jsnap.npz"))
    assert eng.prefix_hits >= 1
    cls = eng.strategy.mgr.pool_class
    src_blocks = {rid: eng.arena.find_mapping(cls, rid).block_ids()
                  for rid in (0, 1)}
    assert set(src_blocks[0]) & set(src_blocks[1])   # COW aliases are live
    preempted = [rid for rid in (0, 1, 2)
                 if eng.arena.find_mapping(cls, rid).placement == "host"]
    assert preempted == [rid for rid in (0, 1, 2) if jeng.arena.find_mapping(
        cls, rid).placement == "host"]

    dst = _engine("torch", gemma, slots=3)
    restored = dst.arena.restore(path)
    dst.arena.check_consistency()
    if not {0, 1} & set(preempted):
        m0, m1 = restored[(cls, 0)], restored[(cls, 1)]
        for i, (a, b) in enumerate(zip(src_blocks[0], src_blocks[1])):
            if a == b:
                assert m0.block_ids()[i] == m1.block_ids()[i]
                assert dst.arena.refcount(cls, m0.block_ids()[i]) == 2
    by_tenant = dst.arena.blocks_by_tenant(cls)
    assert by_tenant == eng.arena.blocks_by_tenant(cls)
    assert by_tenant == jeng.arena.blocks_by_tenant(cls)
    for rid in preempted:
        m = restored[(cls, rid)]
        assert m.placement == "host"
        assert dst.arena.host_contains(cls, rid)
    # every restored device block holds the source block's bytes
    for rid in (0, 1, 2):
        if rid in preempted:
            continue
        old = src_blocks.get(rid) or eng.arena.find_mapping(
            cls, rid).block_ids()
        new = restored[(cls, rid)].block_ids()
        for s_src, s_dst in zip(eng.strategy._streams(),
                                dst.strategy._streams()):
            assert torch.equal(s_src[:, old], s_dst[:, new])
    eng.release_arena()
    dst.release_arena()
    jeng.release_arena()


# ---------------------------------------------------------------------------
# live migration mid-decode, token-identical to the control and to JAX
# ---------------------------------------------------------------------------
def _interleaved_requests(pkg, seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(2, 500, size=16)
    reqs = []
    for i in range(5):
        if i in (1, 3):
            extra = rng.randint(2, 500, size=int(rng.randint(1, 6)))
            prompt = np.concatenate([base, extra])
        else:
            prompt = rng.randint(2, 500, size=int(rng.randint(6, 20)))
        reqs.append(_req(pkg, rid=i, prompt=prompt.copy(),
                         max_new=int(rng.randint(4, 9)), tenant=f"t{i % 2}"))
    return reqs


def _drive_then_migrate(pkg, pair, seed, path):
    """(control tokens, migrated tokens, report, destination engine)."""
    rng = np.random.RandomState(100 + seed)
    pre_steps = int(rng.randint(2, 5))
    preempt_at = int(rng.randint(1, pre_steps + 1))

    def drive(eng):
        for req in _interleaved_requests(pkg, seed):
            eng.submit(req)
        for s in range(pre_steps):
            if s == preempt_at and eng.running:
                eng.preempt_latest()
            eng.step()

    control = _engine(pkg, pair)
    drive(control)
    control.run(max_steps=400)
    control.arena.assert_quiescent()
    src = _engine(pkg, pair)
    drive(src)
    migrate = jmigrate_live if pkg == "jax" else migrate_live
    dst, sess = migrate(src, lambda: _engine(pkg, pair), path)
    dst.run(max_steps=400)
    dst.check_consistency()
    dst.arena.check_consistency()
    dst.arena.assert_quiescent()
    src.release_arena()
    return _tokens(control.done), _tokens(dst.done), \
        sess.migration_report(), dst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_migration_token_identity(gemma, tmp_path, seed):
    """Grow/fork/preempt interleaved with migration: the destination
    resumes every in-flight request and decodes the tokens of the
    port's unmigrated control and of the JAX ``migrate_live``."""
    want, got, rep, dst = _drive_then_migrate(
        "torch", gemma, seed, str(tmp_path / "live.npz"))
    _, jgot, jrep, jdst = _drive_then_migrate(
        "jax", gemma, seed, str(tmp_path / "jlive.npz"))
    assert len(want) == 5 and got == want == jgot
    assert rep == jrep
    assert rep["finalized"] and rep["pause_steps"] == 1
    assert 0 < rep["stop_copy_blocks"] < rep["blocks_per_round"][0]
    dst.release_arena()
    jdst.release_arena()


# ---------------------------------------------------------------------------
# prefill/decode disaggregation: handoff == monolithic == JAX
# ---------------------------------------------------------------------------
def _disaggregated(pkg, pair, requests):
    jm, jp, tm, tp, _ = pair
    if pkg == "jax":
        pre = JPrefillWorker(jm, jp, max_seq=64, num_blocks=24, eos_id=-1,
                             prefill_budget=None)
        dis = JDisaggregatedEngine(pre, _engine(pkg, pair))
    else:
        pre = PrefillWorker(tm, tp, max_seq=64, num_blocks=24, eos_id=-1,
                            prefill_budget=None, device="cpu")
        dis = DisaggregatedEngine(pre, _engine(pkg, pair))
    for req in requests:
        dis.submit(req)
    dis.run(max_steps=300)
    return pre, dis


def test_disaggregated_prefill_token_identity(gemma):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, 500, size=int(rng.randint(5, 18)))
               for _ in range(4)]
    mono = _engine("torch", gemma)
    for i, p in enumerate(prompts):
        mono.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    mono.run(max_steps=300)
    want = _tokens(mono.done)
    mono.arena.assert_quiescent()

    (pre, dis), (jpre, jdis) = (_disaggregated(pkg, gemma, [
        _req(pkg, rid=i, prompt=p.copy(), max_new=6)
        for i, p in enumerate(prompts)]) for pkg in ("torch", "jax"))
    assert _tokens(dis.done) == want == _tokens(jdis.done)
    assert dis.handoffs == jdis.handoffs == 4
    cls = pre.engine.strategy.mgr.pool_class
    nblocks = sum(pre.engine.strategy.mgr.blocks_needed(len(p))
                  for p in prompts)
    assert dis.handoff_bytes == jdis.handoff_bytes == \
        nblocks * pre.engine.arena.block_nbytes(cls)
    assert pre.prefills == 4
    assert pre.engine.arena.num_used(cls) == 1        # the sink alone
    dis.engine.check_consistency()
    assert all(r.t_first >= 0 for r in dis.done)
    dis.engine.arena.assert_quiescent()
    for e in (pre.engine, dis.engine, jpre.engine, jdis.engine):
        e.release_arena()


# ---------------------------------------------------------------------------
# restart: a fresh engine resumes a preempted sequence from the host tier
# ---------------------------------------------------------------------------
def _restart(pkg, pair, path):
    rng = np.random.RandomState(4)
    pr = rng.randint(2, 100, size=9)
    eng = _engine(pkg, pair)
    eng.submit(_req(pkg, rid=0, prompt=pr, max_new=8))
    for _ in range(4):
        eng.step()
    eng.preempt_latest()
    old = eng.sched.preempted.peek()
    assert old.rid == 0 and len(old.generated) > 0
    eng.arena.snapshot(path)         # drains the in-transit swap payload
    eng2 = _engine(pkg, pair)
    restored = eng2.arena.restore(path)
    assert (eng2.strategy.mgr.pool_class, 0) in restored
    eng2.restore_preempted(_req(pkg, rid=0, prompt=pr, max_new=8,
                                generated=list(old.generated),
                                pending_tok=old.pending_tok))
    done = eng2.run(max_steps=200)
    eng2.arena.assert_quiescent()
    uninterrupted = _engine(pkg, pair)
    uninterrupted.submit(_req(pkg, rid=0, prompt=pr, max_new=8))
    want = uninterrupted.run(max_steps=200)[0].generated
    assert done[0].generated[: len(old.generated)] == list(old.generated)
    return done[0].generated, want


def test_restart_resumes_decoding(gemma, tmp_path):
    got, want = _restart("torch", gemma, str(tmp_path / "arena.npz"))
    jgot, jwant = _restart("jax", gemma, str(tmp_path / "jarena.npz"))
    assert got == want == jgot == jwant and len(got) == 8


# ---------------------------------------------------------------------------
# the snapshot schema, both ways, and the transfer plane's teardown
# ---------------------------------------------------------------------------
CLS = "kv"


def _executor_arena(pkg, n=8, layers=1, blk=2, dtype="float32"):
    if pkg == "jax":
        a = JArena()
        a.register_class(CLS, num_blocks=n, block_nbytes=layers * blk * 4)
        cell = {"streams": [jnp.zeros((layers, n, blk), jnp.float32)]}
    else:
        a = Arena()
        dt = getattr(torch, dtype)
        a.register_class(CLS, num_blocks=n, block_nbytes=layers * blk
                         * torch.empty((), dtype=dt).element_size())
        cell = {"streams": [torch.zeros((layers, n, blk), dtype=dt)]}
    a.transfers.register_executor(
        CLS, lambda: list(cell["streams"]),
        lambda s: cell.update(streams=list(s)))
    return a, cell


def _write(pkg, a, cell, m, value):
    a.transfers.dispatch()
    m.assert_settled()
    ids = m.block_ids()
    if pkg == "jax":
        cell["streams"] = [s.at[:, jnp.asarray(ids)].set(value)
                           for s in cell["streams"]]
    else:
        for s in cell["streams"]:
            s[:, ids] = value if not torch.is_tensor(value) else value.to(
                s.dtype)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_snapshot_restore_roundtrip(tmp_path, writer, reader):
    """Host-tier residency and payload bytes survive a snapshot; device
    mappings do not; the restored mapping re-materializes through a new
    executor.  Either package reads the other's float32 snapshot."""
    a, cell = _executor_arena(writer)
    m = a.mapping(CLS, owner=5)
    m.ensure_capacity(2)
    _write(writer, a, cell, m, 6.0)
    m.migrate("host")
    dev = a.mapping(CLS, owner="live")
    dev.ensure_capacity(1)
    path = str(tmp_path / "arena.npz")
    a.snapshot(path)

    b = JArena() if reader == "jax" else Arena()
    restored = b.restore(path)
    mm = restored[(CLS, 5)]
    assert mm.placement == "host" and len(mm) == 2
    assert b.host_counts(CLS) == {5: 2}
    assert b.find_mapping(CLS, "live") is None
    pa, na = a._host_payload[(CLS, 5)]
    pb, nb = b._host_payload[(CLS, 5)]
    assert na == nb
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if reader == "jax":
        cell2 = {"streams": [jnp.zeros((1, 8, 2), jnp.float32)]}
    else:
        cell2 = {"streams": [torch.zeros((1, 8, 2))]}
    b.transfers.register_executor(
        CLS, lambda: list(cell2["streams"]),
        lambda s: cell2.update(streams=list(s)))
    new_ids = mm.migrate("device")
    b.transfers.drain()
    np.testing.assert_array_equal(
        np.asarray(cell2["streams"][0])[:, np.asarray(new_ids)],
        np.full((1, 2, 2), 6.0, np.float32))
    mm.free()
    b.assert_quiescent()


@pytest.mark.parametrize("spec", [dict(num_blocks=16, block_nbytes=8),
                                  dict(num_blocks=8, block_nbytes=16),
                                  dict(num_blocks=8, block_nbytes=8,
                                       dtype=torch.bfloat16)])
def test_restore_rejects_spec_mismatch(tmp_path, spec):
    a, _ = _executor_arena("torch")
    path = str(tmp_path / "arena.npz")
    a.snapshot(path)
    b = Arena()
    b.register_class(CLS, **spec)
    with pytest.raises(ValueError):
        b.restore(path)


def test_bfloat16_snapshot_roundtrip_is_bitwise(tmp_path):
    """A bfloat16 pool (no numpy dtype) round-trips bit for bit: device
    payload through fresh ids, host payload byte for byte, and the
    dtype recorded by the reference's name."""
    a, cell = _executor_arena("torch", n=8, layers=3, blk=5,
                              dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    cell["streams"][0].copy_(torch.randn(3, 8, 5, generator=g))
    m1 = a.mapping(CLS, owner=1, tenant="x")
    m1.ensure_capacity(3)
    m2 = a.mapping(CLS, owner=2)
    m2.ensure_capacity(2)
    m2.migrate("host")
    a.transfers.drain()
    path = str(tmp_path / "bf16.npz")
    a.snapshot(path, include_device=True)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
    assert meta["device"][CLS]["streams"][0]["dtype"] == "bfloat16"
    assert meta["payloads"][0]["streams"][0]["dtype"] == "bfloat16"

    b, cell_b = _executor_arena("torch", n=8, layers=3, blk=5,
                                dtype="bfloat16")
    b.lease_blocks(CLS, "pad", 3)                  # restore onto new ids
    restored = b.restore(path)
    new = restored[(CLS, 1)].block_ids()
    assert new != m1.block_ids()
    src = cell["streams"][0][:, m1.block_ids()]
    got = cell_b["streams"][0][:, new]
    assert torch.equal(src.view(torch.int16), got.view(torch.int16))
    pa, _ = a._host_payload[(CLS, 2)]
    pb, _ = b._host_payload[(CLS, 2)]
    assert pb[0].dtype == torch.bfloat16
    assert torch.equal(pa[0].view(torch.int16), pb[0].view(torch.int16))
    assert b.blocks_by_tenant(CLS)["x"] == 3


def _plane_ops(pkg):
    a, _ = _executor_arena(pkg, n=12)
    m = a.mapping(CLS, owner=0)
    m.ensure_capacity(3)
    n = a.mapping(CLS, owner=1)
    n.ensure_capacity(2)
    a.transfers.enqueue_swap_out(CLS, "o", m.block_ids(), kind="migrate-out",
                                 lane="background")
    a.transfers.enqueue_swap_out(CLS, "p", n.block_ids())
    depths = a.transfers.queue_depths()
    with pytest.raises(ValueError):
        a.transfers.unregister_executor(CLS)
    a.transfers.drain()
    a.transfers.add_observer(lambda plan: None, key="ledger")
    a.transfers.remove_observer("ledger")
    a.transfers.remove_observer("absent")
    a.transfers.unregister_executor(CLS)
    return depths, a.transfers.has_executor(CLS), len(a.transfers._observers)


def test_transfer_plane_teardown_and_queue_depths():
    assert _plane_ops("torch") == _plane_ops("jax")


# ---------------------------------------------------------------------------
# a JAX engine's snapshot restores into the port's engine
# ---------------------------------------------------------------------------
def _port_request(jreq):
    kw = {f.name: getattr(jreq, f.name) for f in dataclasses.fields(Request)}
    kw["prompt"] = np.asarray(kw["prompt"]).copy()
    kw["generated"] = list(kw["generated"])
    return Request(**kw)


def _port_plane(plane):
    return {**plane,
            "running": {s: (_port_request(r), t)
                        for s, (r, t) in plane["running"].items()},
            "queued": [_port_request(r) for r in plane["queued"]],
            "preempted": [_port_request(r) for r in plane["preempted"]],
            "done": [_port_request(r) for r in plane["done"]]}


def test_jax_snapshot_restores_into_port_engine(gemma, tmp_path):
    """A reduced float32 gemma_2b JAX engine is stopped mid-decode with
    one sequence on the host tier; its ``repro.mem.Arena`` snapshot
    (device payload included) restores into the port's engine, which
    resumes every request to the JAX engine's tokens."""
    def drive(eng, pkg):
        for req in _interleaved_requests(pkg, 0):
            eng.submit(req)
        for _ in range(3):
            eng.step()
        eng.preempt_latest()

    control = _engine("jax", gemma)
    drive(control, "jax")
    control.run(max_steps=400)
    want = _tokens(control.done)
    jeng = _engine("jax", gemma)
    drive(jeng, "jax")
    plane = jcapture(jeng)
    assert plane["running"] and plane["preempted"]
    path = str(tmp_path / "jax.npz")
    jeng.arena.snapshot(path, include_device=True)
    dst = _engine("torch", gemma)
    restored = dst.arena.restore(path)
    assert {p for (_, p) in restored} == {
        r.rid for r in list(jeng.running.values()) + plane["preempted"]}
    resume_engine(dst, _port_plane(plane))
    dst.run(max_steps=400)
    assert _tokens(dst.done) == want and len(want) == 5
    dst.arena.assert_quiescent()
    dst.release_arena()
    jeng.release_arena()


# ---------------------------------------------------------------------------
# the constant-state pool and the hybrid: both pool classes move
# ---------------------------------------------------------------------------
def _state_requests(pkg, cfg):
    rng = np.random.RandomState(1)
    return [_req(pkg, rid=i, prompt=rng.randint(
        2, cfg.vocab_size, size=int(rng.randint(5, 9))), max_new=n)
            for i, n in enumerate((8, 6, 7, 5))]


@functools.lru_cache(maxsize=None)
def _jax_state_tokens(arch):
    """The JAX engine's tokens for ``_state_requests``, run once."""
    eng = _engine("jax", _pair(arch))
    for req in _state_requests("jax", _pair(arch)[4]):
        eng.submit(req)
    eng.run(max_steps=300)
    eng.release_arena()
    return _tokens(eng.done)


@pytest.mark.parametrize("mode", ["migrate", "disaggregate"])
def test_state_models_migrate_and_disaggregate(state_arch, tmp_path, mode):
    """Reduced mamba2_370m (one state pool) and zamba2_2p7b (paged KV +
    state): live migration after a preemption, and the disaggregated
    prefill with one bundle per pool class, each token-identical to the
    JAX engine on the same requests (the migration also to the port's
    unmigrated control)."""
    state_pair = _pair(state_arch)
    cfg = state_pair[4]
    hybrid = cfg.family == "hybrid"
    if mode == "migrate":
        control, src = (_engine("torch", state_pair) for _ in range(2))
        for eng in (control, src):
            for req in _state_requests("torch", cfg):
                eng.submit(req)
            for s in range(3):
                if s == 1:
                    eng.preempt_latest()
                eng.step()
        control.run(max_steps=300)
        dst, sess = migrate_live(src, lambda: _engine("torch", state_pair),
                                 str(tmp_path / "live.npz"))
        dst.run(max_steps=300)
        rep = sess.migration_report()
        assert _tokens(dst.done) == _tokens(control.done)
        assert rep["finalized"] and rep["stop_copy_blocks"] > 0
        # every decode rewrites each running row's whole state block, so
        # the state class's tail is every running row, every round
        running = len(src.running)
        assert rep["stop_copy_blocks"] >= running
        src.release_arena()
    else:
        pre, dis = _disaggregated("torch", state_pair,
                                  _state_requests("torch", cfg))
        dst = dis.engine
        assert dis.handoffs == 4
        state_cls = pre.engine.strategy.pool_classes[-1]
        assert pre.engine.arena.num_used(state_cls) == 1   # the sink alone
        block = 4 * state_pair[2].state_elems
        kv = 0
        if hybrid:
            mgr = pre.engine.strategy.mgr
            kv = sum(mgr.blocks_needed(len(r.prompt)) for r in
                     _state_requests("torch", cfg)) * pre.engine.arena\
                .block_nbytes(mgr.pool_class)
        assert dis.handoff_bytes == 4 * block + kv
        pre.engine.release_arena()
    assert _tokens(dst.done) == _jax_state_tokens(state_arch)
    assert len(dst.done) == 4
    dst.arena.assert_quiescent()
    dst.release_arena()


# ---------------------------------------------------------------------------
# the device token latch, adopt errors, release and the engine options
# ---------------------------------------------------------------------------
def _record_inputs(eng):
    seen, tail = [], eng.strategy.decode_resident

    def recorded(params, tokens):
        seen.append(tokens.clone())
        return tail(params, tokens)
    eng.strategy.decode_resident = recorded
    return seen


def test_first_step_after_resume_decodes_the_carried_token(gemma, tmp_path):
    """``resume_engine`` and ``DecodeWorker.adopt`` write the host latch
    and mark the device copy stale: the next step decodes the carried
    tokens even when the device holds a stale latch."""
    src = _engine("torch", gemma)
    for req in _interleaved_requests("torch", 1):
        src.submit(req)
    for _ in range(3):
        src.step()
    src_slots = sorted(src.running)
    dst, _ = migrate_live(src, lambda: _engine("torch", gemma),
                          str(tmp_path / "m.npz"))
    carried = {s: int(dst._next_tok[s]) for s in src_slots}
    dst._tok_dev = torch.full((2,), 7, dtype=torch.long)   # a stale latch
    seen = _record_inputs(dst)
    running = {s: r.rid for s, r in dst.running.items()}
    dst.step()
    for slot in running:
        assert int(seen[0][slot]) == carried[slot]
        assert dst.done + list(dst.running.values())   # decoded on
    # adopt into a live engine that has latched its own tokens
    pre, dis = _disaggregated("torch", gemma, [])
    eng = dis.engine
    rng = np.random.RandomState(2)
    eng.submit(Request(rid=10, prompt=rng.randint(2, 500, size=7),
                       max_new=6))
    eng.step()
    eng.step()
    seen = _record_inputs(eng)
    req = Request(rid=11, prompt=rng.randint(2, 500, size=9), max_new=4)
    first, bundles = pre.prefill_one(req)
    slot = dis.decode.adopt(req, bundles, first)
    eng.step()
    assert int(seen[0][slot]) == first
    assert req.generated[0] == first
    eng.run(max_steps=100)
    eng.arena.assert_quiescent()
    for e in (dst, src, pre.engine, eng):
        e.release_arena()


@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m", "zamba2_2p7b"])
@pytest.mark.parametrize("verb", ["adopt_restored", "adopt_device"])
def test_adopt_errors_match_reference(arch, verb):
    """A missing or wrongly placed mapping raises the reference's
    message on every strategy; a rightly placed one is adopted."""
    pair = _pair(arch)
    msgs = []
    for pkg in ("torch", "jax"):
        strat = _engine(pkg, pair).strategy
        with pytest.raises(ValueError) as missing:
            getattr(strat, verb)(99)
        wrong = "device" if verb == "adopt_restored" else "host"
        for cls in strat.pool_classes:       # rid 0, placed wrong
            m = strat.arena.mapping(cls, 0)
            m.ensure_capacity(1)
            if wrong == "host":
                m.migrate("host")
        strat.arena.transfers.drain()
        with pytest.raises(ValueError) as placed:
            getattr(strat, verb)(0)
        for cls in strat.pool_classes:       # rid 1, placed right
            m = strat.arena.mapping(cls, 1)
            m.ensure_capacity(1)
            if wrong == "device":
                m.migrate("host")
        strat.arena.transfers.drain()
        getattr(strat, verb)(1)
        assert strat.mgr.mapping(1) is strat.arena.find_mapping(
            strat.mgr.pool_class, 1)
        msgs.append((str(missing.value), str(placed.value)))
    assert msgs[0] == msgs[1]


def test_release_arena_unbinds_the_engine(gemma):
    """``release_arena`` drains, unbinds the reclaimers, executors and
    swap ledgers and drops the decode graphs; the arena then takes a new
    engine of the same geometry."""
    eng = _engine("torch", gemma)
    eng.submit(Request(rid=0, prompt=np.arange(2, 14), max_new=3))
    eng.run(max_steps=50)
    assert eng.strategy._graphs is not None
    arena = eng.arena
    eng.release_arena()
    cls = eng.strategy.mgr.pool_class
    assert not arena.transfers.has_executor(cls)
    assert not arena._reclaimers
    assert f"swap-ledger:{cls}" not in arena.transfers._observers
    assert eng.strategy.graph_stats["pool_bytes"] == 0
    eng2 = Engine(gemma[2], gemma[3], arena=arena, device="cpu",
                  **{**ENGINE_KW, "num_blocks": 24})
    eng2.submit(Request(rid=1, prompt=np.arange(2, 14), max_new=3))
    eng2.run(max_steps=50)
    assert len(eng2.done) == 1


@pytest.mark.parametrize("option", ["share_prefixes", "prefetch"])
def test_engine_options_match_reference(gemma, option):
    """``share_prefixes=False`` and ``prefetch=False`` turn prefix
    sharing and speculative swap-in off as in the JAX engine: the same
    tokens, prefix hits, prefetches and preemptions."""
    rng = np.random.RandomState(6)
    base = rng.randint(2, 500, size=16)
    prompts = [base, np.concatenate([base, rng.randint(2, 500, size=3)]),
               rng.randint(2, 500, size=11), base.copy()]
    out = []
    for pkg in ("torch", "jax"):
        eng = _engine(pkg, gemma, slots=3, num_blocks=10, watermark=0,
                      **{option: False})
        for i, p in enumerate(prompts):
            eng.submit(_req(pkg, rid=i, prompt=p.copy(), max_new=12))
        for _ in range(3):
            eng.step()
        eng.preempt_latest()
        eng.run(max_steps=300)
        eng.arena.assert_quiescent()
        out.append((_tokens(eng.done), eng.prefix_hits, eng.prefetches,
                    eng.preemptions, eng.share_prefixes,
                    eng.prefetch_enabled))
        eng.release_arena()
    assert out[0] == out[1]
    assert not out[0][4 if option == "share_prefixes" else 5]
    if option == "share_prefixes":
        assert out[0][1] == 0
    else:
        assert out[0][2] == 0
