"""The static-shape resident decode tail against the JAX package.

``serve/decode_graph.py`` runs each strategy's resident decode tail on
static buffers, one set per power-of-two update width W, and on a CUDA
device replays one captured graph per W (``tests/test_torch_cuda.py``
holds the replay against the eager tail on the card).  On the CPU the
same buffers, bucketing and on-device drop run eagerly.  For the three
disciplines -- reduced ``gemma_2b`` (paged KV), ``mamba2_370m``
(constant state) and ``zamba2_2p7b`` (both), float32 on the CPU:

* the splice drops pad entries on the device as the reference's
  ``.at[upd_slots].set(..., mode="drop")`` does: the same numpy update
  arrays, pads at ``slots``, give the same tables, lengths and rows,
  exactly; the pads land in the resident tensors' scratch row, which no
  step reads (poisoning it changes nothing);
* over a scripted engine run with a forced preemption and a compaction,
  the buckets' static buffers and the resident tables, lengths and rows
  keep their storage from step to step;
* that run gives the JAX engine's tokens, preemptions, swap ledger after
  every step, prefix hits, saved prefill tokens, COW copies, compactions
  and steps.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.kernels import ops
from repro_torch.mem import Arena
from repro_torch.serve.arch import build_strategy
from test_torch_engine import (assert_same, drive, make_pair,
                               preempt_and_compact)
from test_torch_ssm import ssm_pair

torch.set_num_threads(1)

ARCHS = ["gemma_2b", "mamba2_370m", "zamba2_2p7b"]
SLOTS = 4
#: what each strategy's resident tensors are, by their number
KINDS = {2: ("tables", "lens"), 1: ("rows",), 3: ("tables", "lens", "rows")}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    return make_pair(arch) if arch == "gemma_2b" else ssm_pair(arch)


def _strategy(pair):
    return build_strategy(pair[2], arena=Arena(), slots=SLOTS, max_seq=32,
                          num_blocks=12, device="cpu")


def _kinds(strat):
    return KINDS[len(strat._resident)]


def _random_rows(strat, kind, rng, n):
    """``n`` random valid rows of a resident tensor: tables of pool
    blocks, short lengths, distinct state rows."""
    if kind == "tables":
        nb = strat.cache.k_pool.shape[1]
        mb = strat.cache.config.max_blocks_per_seq
        return rng.integers(0, nb, (n, mb))
    if kind == "lens":
        return rng.integers(1, 12, n)
    rows = getattr(strat, "state_mgr", strat.mgr).pool.shape[0]
    return rng.permutation(rows)[:n]


def _fill(strat, rng):
    """Random valid contents for the resident tensors' ``slots`` rows and
    random pools."""
    for kind, r in zip(_kinds(strat), strat._resident):
        r[:SLOTS] = torch.from_numpy(_random_rows(strat, kind, rng, SLOTS))
    for p in strat._pools():
        p.copy_(torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32)))


def _update(strat, rng, slots):
    """The host update arrays of width 4 for ``slots`` (the rest pads),
    with random valid values."""
    upd = strat._pad_update(4)
    upd[0][: len(slots)] = slots
    for kind, a in zip(_kinds(strat), upd[1:]):
        a[: len(slots)] = _random_rows(strat, kind, rng, len(slots))
    return upd


@pytest.mark.parametrize("slots", [(2, 0), (3, 1, 0, 2), ()])
def test_pads_are_dropped_on_the_device_as_in_jax(pair, slots):
    """The same update arrays through ``.at[upd_slots].set(...,
    mode="drop")`` and through the strategy's resident tail: the first
    ``slots`` rows of the tables, lengths (then advanced by the step) and
    rows equal JAX's exactly; pads land in the scratch row."""
    rng = np.random.default_rng(len(slots))
    strat = _strategy(pair)
    strat.resident = True
    _fill(strat, rng)
    before = [r.numpy()[:SLOTS].copy() for r in strat._resident]
    upd = _update(strat, rng, slots) if slots else strat._pad_update(0)
    want = [np.asarray(jnp.asarray(b).at[jnp.asarray(upd[0])].set(
        jnp.asarray(v.astype(b.dtype)), mode="drop"))
        for b, v in zip(before, upd[1:])]
    strat._upd = upd
    tokens = torch.from_numpy(rng.integers(2, 500, SLOTS))
    nxt = strat.decode_resident(pair[3], tokens)
    assert tuple(nxt.shape) == (SLOTS,)
    for kind, r, w in zip(_kinds(strat), strat._resident, want):
        got = r.numpy()[:SLOTS]
        assert np.array_equal(got, w + 1 if kind == "lens" else w), kind
    if len(slots) < 4:                       # a pad reached the scratch row
        pads = strat._pad_update(1)[1:]
        for r, p in zip(strat._resident, pads):
            assert np.array_equal(r.numpy()[SLOTS], p[0])


def test_scratch_row_is_never_read(pair):
    """Two strategies in the same state, one with its scratch row
    poisoned (a live block, a length, a live state row): a steady-state
    step (W = 0) gives the same tokens, pools and resident rows."""
    out = []
    for poison in (False, True):
        rng = np.random.default_rng(5)
        strat = _strategy(pair)
        strat.resident = True
        _fill(strat, rng)
        if poison:
            for kind, r in zip(_kinds(strat), strat._resident):
                r[SLOTS] = 7 if kind == "lens" else r[1]
        strat._upd = strat._pad_update(0)
        tokens = torch.from_numpy(rng.integers(2, 500, SLOTS))
        nxt = strat.decode_resident(pair[3], tokens)
        pools = [p.clone() for p in strat._pools()]
        out.append((nxt, pools, [r[:SLOTS].clone() for r in strat._resident]))
    (n0, p0, r0), (n1, p1, r1) = out
    assert torch.equal(n0, n1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(r0, r1))


def _storage(eng, state):
    """Hook: the storage of every bucket's static buffers, the static
    token vector and the resident tables, lengths and rows, after every
    step."""
    strat = eng.strategy
    g = strat._graphs
    ptr = lambda t: t.untyped_storage().data_ptr()   # noqa: E731
    views = [getattr(eng.cache, "block_tables", None),
             getattr(eng.cache, "seq_lens", None),
             getattr(strat, "_rows_dev", None)]
    state.setdefault("ptrs", []).append((
        {W: tuple(ptr(b) for b in bufs) for W, bufs in g._inputs.items()},
        ptr(g.tokens),
        tuple(ptr(t) for t in views if t is not None),
        tuple(ptr(t) for t in strat._resident)))


@pytest.fixture(scope="module")
def runs(pair):
    """The scripted workload on both engines: six requests of mixed
    lengths on 4 slots, a forced LIFO preemption after step 3 and a
    compaction, so the update widths reach every bucket."""
    cfg = pair[4]
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(2, cfg.vocab_size, size=int(rng.randint(5, 20))), n)
            for n in (9, 4, 7, 3, 6, 5)]
    paged = hasattr(pair[2], "kv_config")
    kw = dict(slots=SLOTS, max_seq=48, num_blocks=18 if paged else 8)
    force = preempt_and_compact(3)

    def hook(eng, state):
        force(eng, state)
        _storage(eng, state)

    j = drive("jax", pair, reqs, kw, hook=force)
    t = drive("torch", pair, reqs, kw, hook=hook)
    return j, t


def test_static_buffers_and_resident_tensors_keep_their_storage(runs):
    """Every bucket's buffers, the token vector and the resident tables,
    lengths and rows are allocated once: the same storage after every
    step of a run that preempts, compacts and crosses the buckets."""
    _, t = runs
    ptrs = t["state"]["ptrs"]
    first = {}
    for bufs, _, _, _ in ptrs:
        for W, p in bufs.items():
            assert first.setdefault(W, p) == p, W
    assert set(first) == {0, 1, 2, 4}, sorted(first)
    for _, tok, views, res in ptrs:
        assert (tok, views, res) == ptrs[0][1:]
    g = t["engine"].strategy._graphs
    assert not g.graphs and g.replays == 0 and not g.captures


def test_static_tail_engine_matches_jax(runs):
    """Tokens, preemptions, the swap ledger after every step, prefix
    hits, saved prefill tokens, COW copies, compactions and steps equal
    the JAX engine's."""
    j, t = runs
    assert_same(j, t)
    assert t["preemptions"] >= 1 and t["state"]["moved"] > 0
    assert len(t["tokens"]) == 6


def test_launch_counts_add_and_take_back():
    """``add_launch_counts`` adds a replay's launches, and negative
    counts take a capture's own back out."""
    before = ops.launch_counts()
    ops.add_launch_counts({"paged_attention_append": 3, "block_copy": 1})
    mid = ops.launch_counts()
    assert mid["paged_attention_append"] == before["paged_attention_append"] + 3
    assert mid["block_copy"] == before["block_copy"] + 1
    ops.add_launch_counts({"paged_attention_append": -3, "block_copy": -1})
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_eager_decode_flag(arch, capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--trace",
                 "prefixheavy", "--prefill-budget", "none",
                 "--eager-graphs"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "served 3/3 requests on cpu" in capsys.readouterr().out
