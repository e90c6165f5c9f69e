"""The paged prefill buckets' static buffers against the JAX package.

``serve/prefill_graph.py`` runs a ``PagedKVStrategy``'s prefill and
suffix prefill on static buffers, one set per ``(kind, B, S)`` bucket,
and on a CUDA device replays one captured graph per bucket from its
second sighting on (``tests/test_torch_cuda.py`` holds the replay
against the eager call on the card).  On the CPU the same buffers run
eagerly.  For reduced ``gemma_2b`` (suffix prefill), ``minicpm3_4b``
(MLA: a forked prompt is recomputed) and ``qwen3_moe_30b_a3b`` (MoE,
suffix prefill), float32 on the CPU:

* a scripted engine run with forks, a forced preemption and a compaction
  gives the JAX engine's tokens, preemptions, swap ledger after every
  step, prefix hits, saved prefill tokens and steps;
* the strategy's buckets and their sightings are exactly the ``(B, S)``
  shapes the JAX model's ``prefill`` and ``prefill_suffix`` receive in
  the same run (the reference's jit keys);
* every bucket's buffers keep their storage over that run;
* the warm-up body, on all-pad inputs over poisoned pools, writes the
  sink block and nothing else;
* with the CUDA graph calls stood in for by stubs, a bucket runs eagerly
  at its first sighting, is captured at its second and replayed from
  then on, a moved pool recaptures it once, and the launch counters add
  the capture's counts at each replay and take the warm-up's and the
  capture's own back out;
* ``Engine(graphs=False)`` turns the prefill graphs off with the decode
  graphs.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro_torch.kernels import ops
from repro_torch.mem import Arena
from repro_torch.serve import graphs as G
from repro_torch.serve.arch import build_strategy
from repro_torch.serve.engine import Engine
from repro_torch.serve.prefill_graph import (PREFILL_WARMUP, PrefillGraphs,
                                             bucket_name)
from repro_torch.serve.scheduler import Request
from test_torch_engine import (assert_same, drive, make_pair,
                               preempt_and_compact)

torch.set_num_threads(1)

ARCHS = ["gemma_2b", "minicpm3_4b", "qwen3_moe_30b_a3b"]
ENGINE_KW = dict(slots=3, max_seq=64, num_blocks=20, watermark=1)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


@pytest.fixture(scope="module")
def arch(pair):
    return {"gemma-2b": "gemma_2b", "minicpm3-4b": "minicpm3_4b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b"}[pair[4].name]


def _workload(cfg):
    """Seven requests at the start -- a base prompt, its forks (whole and
    extended), unrelated prompts -- and three short ones submitted after
    steps 8, 14 and 16, so that a bucket repeats on every family; returns
    (requests, the hook that forces a preemption and a compaction and
    submits the late ones)."""
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, size=16)
    other = lambda n: rng.randint(2, cfg.vocab_size, size=n)  # noqa: E731
    reqs = [(base, 10), (other(9), 6), (base, 6),
            (np.concatenate([base, other(5)]), 6), (other(5), 6),
            (np.concatenate([base, other(3)]), 5), (other(13), 5)]
    late = {8: other(6), 14: other(7), 16: other(4)}
    force = preempt_and_compact(3)

    def hook(eng, state):
        force(eng, state)
        sent = state.setdefault("late", set())
        if eng.steps in late and eng.steps not in sent:
            sent.add(eng.steps)
            req_cls = Request if isinstance(eng, Engine) else JRequest
            eng.submit(req_cls(rid=100 + eng.steps,
                               prompt=late[eng.steps].copy(), max_new=4))
    return reqs, hook


def _record_shapes(jm):
    """Wrap the JAX model's ``prefill`` and ``prefill_suffix`` on the
    instance; returns the list their calls' ``(kind, B, S)`` go to."""
    seen = []

    def wrap(name, kind, tokens_of):
        fn = getattr(jm, name)

        def recorded(*args, **kw):
            seen.append((kind,) + tuple(np.shape(tokens_of(args))))
            return fn(*args, **kw)
        setattr(jm, name, recorded)

    wrap("prefill", "prefill", lambda a: a[1]["tokens"])
    wrap("prefill_suffix", "suffix", lambda a: a[1])
    return seen


def _storage(eng, state):
    """Hook: every bucket's buffer storage after every step."""
    pg = eng.strategy._prefill_graphs
    if pg is None:
        return
    ptr = lambda t: t.untyped_storage().data_ptr()   # noqa: E731
    state.setdefault("ptrs", []).append(
        {k: tuple(ptr(b) for b in bufs) for k, bufs in pg._inputs.items()})


@pytest.fixture(scope="module")
def runs(pair):
    """The workload on both engines, the JAX model's prefill shapes
    recorded, the port's bucket buffers watched."""
    reqs, force = _workload(pair[4])
    jm = pair[0]
    shapes = _record_shapes(jm)
    try:
        j = drive("jax", pair, reqs, ENGINE_KW, hook=force)
    finally:
        del jm.prefill, jm.prefill_suffix

    def hook(eng, state):
        force(eng, state)
        _storage(eng, state)

    t = drive("torch", pair, reqs, ENGINE_KW, hook=hook)
    return j, t, shapes


def test_bucketed_prefill_engine_matches_jax(runs):
    """Tokens, preemptions, the swap ledger after every step, prefix
    hits, saved prefill tokens, COW copies, compactions and steps equal
    the JAX engine's."""
    j, t, _ = runs
    assert_same(j, t)
    assert t["preemptions"] >= 1 and t["prefix_hits"] >= 2
    assert len(t["tokens"]) == 10


def test_buckets_are_the_reference_jit_keys(runs):
    """The buckets and their sightings are the shapes the JAX model's
    ``prefill`` and ``prefill_suffix`` received; some bucket repeats, and
    on the CPU every sighting ran eagerly and nothing was captured."""
    _, t, shapes = runs
    eng = t["engine"]
    pg = eng.strategy._prefill_graphs
    assert pg.sightings == dict(collections.Counter(shapes))
    assert max(pg.sightings.values()) >= 2
    kinds = {k for k, _, _ in shapes}
    assert ("suffix" in kinds) == eng.suffix_prefill
    assert kinds & {"prefill"}
    st = eng.stats["prefill_graphs"]
    assert st["graphs"] is False and not st["captures"]
    assert st["replays"] == 0 and st["recaptures"] == 0
    assert {name: b["eager"] for name, b in st["buckets"].items()} == {
        bucket_name(k): n for k, n in pg.sightings.items()}


def test_bucket_buffers_keep_their_storage(runs):
    """Every bucket's buffers are allocated once, at its first sighting,
    and keep their storage through preemption and compaction."""
    _, t, _ = runs
    first = {}
    for step in t["state"]["ptrs"]:
        for key, ptrs in step.items():
            assert first.setdefault(key, ptrs) == ptrs, key
    assert set(first) == set(t["engine"].strategy._prefill_graphs.sightings)


# ---------------------------------------------------------------------------
# the warm-up and the sightings, on one strategy
# ---------------------------------------------------------------------------
def _strategy(pair, seed=1):
    """A strategy on ``pair``'s model with its pools poisoned."""
    strat = build_strategy(pair[2], arena=Arena(), slots=4, max_seq=64,
                           num_blocks=12, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for p in strat._pools():
        p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype))
    return strat


def _kinds(strat):
    return ("prefill", "suffix") if strat.supports_suffix_prefill else (
        "prefill",)


@pytest.mark.parametrize("B,S", [(1, 8), (3, 24)])
def test_warmup_writes_only_the_sink(pair, B, S):
    """The warm-up's all-pad inputs (sink tables and write tables, never
    NULL) through the body, over poisoned pools: the sink block changes,
    every other block keeps its bits."""
    strat = _strategy(pair)
    for kind in _kinds(strat):
        pad = strat._prefill_pad(kind, B, S)
        assert all((a != -1).all() for a in pad[1:])
        before = [p.clone() for p in strat._pools()]
        nxt, last = strat._prefill_body(
            pair[3], kind, tuple(torch.from_numpy(a) for a in pad))
        assert tuple(nxt.shape) == (B,) and tuple(last.shape) == (
            B, pair[4].vocab_size)
        for b, p in zip(before, strat._pools()):
            others = [i for i in range(p.shape[1]) if i != strat.sink]
            assert torch.equal(b[:, others], p[:, others]), kind
            assert not torch.equal(b[:, strat.sink], p[:, strat.sink]), kind


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    replayed = 0

    def replay(self):
        _Graph.replayed += 1


@pytest.fixture
def stub_graphs(monkeypatch):
    """``torch.cuda``'s graph calls stood in for on the CPU: a capture
    runs its body once (as the recording would not), a replay runs
    nothing."""
    _Graph.replayed = 0
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(G.GraphPool, "side", lambda self: _Stream())
    return _Graph


def _counted_body(strat, launches):
    """The strategy's prefill body, counting one #2 launch a run as the
    CUDA wrapper would (the CPU's plain version counts none)."""
    body = strat._prefill_body

    def counted(*args):
        ops.add_launch_counts({"paged_prefill_attention": 1})
        launches.append(args[1])
        return body(*args)
    strat._prefill_body = counted


def test_sightings_capture_at_the_second_and_launch_counts_add_back(
        pair, stub_graphs):
    """Three sightings of one bucket with graphs on: eager, then the
    capture (``PREFILL_WARMUP`` warm-up runs and the recording) and a replay,
    then a replay; the counter reads three launches, as three eager
    calls would.  A moved pool drops the graph: the next sighting
    captures the bucket again, once."""
    strat = _strategy(pair)
    bodies = []
    _counted_body(strat, bodies)
    pg = PrefillGraphs(torch.device("cpu"), pool=G.GraphPool(
        torch.device("cpu")))
    pg.graphs = True
    strat._prefill_graphs = pg
    params = pair[3]
    rng = np.random.default_rng(0)
    arrays = strat._prefill_pad("prefill", 2, 16)
    before = ops.launch_counts()
    for n in range(1, 4):
        arrays[0][:] = rng.integers(2, 100, arrays[0].shape)
        nxt = pg.run(strat, params, "prefill", arrays)
        assert tuple(nxt.shape) == (2,)
        assert np.array_equal(pg._inputs[("prefill", 2, 16)][0].numpy(),
                              arrays[0])
        got = ops.launch_counts()
        assert (got["paged_prefill_attention"]
                - before["paged_prefill_attention"]) == n
    key = ("prefill", 2, 16)
    assert len(bodies) == 1 + PREFILL_WARMUP + 1  # eager, warm-up, capture
    assert pg.sightings[key] == 3 and pg.eager[key] == 1
    assert pg._set.replays[key] == 2 and stub_graphs.replayed == 2
    assert pg.stats["captures"] == {"prefill 2x16": 1}
    assert pg.stats["recaptures"] == 0
    strat._set_streams([p.clone() for p in strat._streams()])
    pg.run(strat, params, "prefill", arrays)
    st = pg.stats
    assert st["captures"] == {"prefill 2x16": 2} and st["recaptures"] == 1
    assert st["buckets"]["prefill 2x16"] == {
        "sightings": 4, "captures": 2, "replays": 3, "eager": 1}
    assert (ops.launch_counts()["paged_prefill_attention"]
            - before["paged_prefill_attention"]) == 4
    pg.release()
    assert pg._set.pool.graphs == 0 and pg.last is None


def test_graph_pool_is_shared_and_dropped_with_its_last_graph(stub_graphs):
    """Two sets in one pool: both capture under one handle, which stays
    while either set holds a graph and goes with the last; a set whose
    tensors moved drops its graphs."""
    pool = G.GraphPool(torch.device("cpu"))
    a, b = G.GraphSet(pool), G.GraphSet(pool)
    x = [torch.zeros(2)]
    for s, key in ((a, 0), (b, ("prefill", 1, 8))):
        s.check(x)
        s.capture(key, lambda: None, lambda: torch.zeros(1))
    handle = pool._handle
    assert handle is not None and pool.graphs == 2
    a.release()
    assert pool.graphs == 1 and ("prefill", 1, 8) in b
    b.check(x)
    assert pool._handle is handle and b.recaptures == 0
    b.check([torch.zeros(3)])
    assert pool.graphs == 0 and pool._handle is None and b.recaptures == 1


def test_engine_takes_eager_graphs(pair):
    """``Engine(graphs=False)`` is one switch for both kinds: the
    strategy's decode tail and prefill buckets run eagerly."""
    eng = Engine(pair[2], pair[3], eos_id=-1, prefill_budget=None,
                 device="cpu", graphs=False, **ENGINE_KW)
    assert eng.strategy.graphs is False
    eng.submit(Request(rid=0, prompt=np.arange(2, 14), max_new=3))
    eng.run(max_steps=20)
    assert len(eng.done) == 1 and len(eng.done[0].generated) == 3
    st = eng.stats
    assert st["decode_graphs"]["graphs"] is False
    assert st["prefill_graphs"]["buckets"] == {
        "prefill 1x16": {"sightings": 1, "captures": 0, "replays": 0,
                         "eager": 1}}
