"""The constant-state and composite disciplines against the JAX package.

Reduced ``mamba2_370m`` and ``rwkv6_7b`` (one float32 state block per
sequence in a flat Arena pool, ``ConstantStateStrategy``) and
``zamba2_2p7b`` (that state plus paged KV for the shared-attention
invocations, ``CompositeStrategy``), float32 on the CPU, with the JAX
parameters converted through numpy (Zamba2's LoRA factors drawn, see
``test_torch_ssm.ssm_pair``):

* the registry resolves each family to its discipline; audio and vision
  stay refused; the three models build at their published widths with
  the reference's state block sizes;
* model logits within TOL = 1e-4 of JAX's after a prefill of mixed
  lengths and over several decode steps, with identical greedy tokens;
* the engine against the JAX engine on one scripted workload with a
  forced preemption and a state-pool compaction: per-request tokens,
  preemptions, compactions, steps and the swap ledger after every step
  (the state class's too for the hybrid); both Arenas end quiescent;
* an exact preempt and resume; resident decode equal to eager decode
  across a preemption; three disciplines serving concurrently from one
  shared Arena, token-identical to standalone runs.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.configs.base import get_config
from repro_torch.mem import Arena
from repro_torch.models.api import build_model
from repro_torch.models.mamba2_lm import Mamba2LM
from repro_torch.models.rwkv_lm import RWKVLM
from repro_torch.models.zamba2 import Zamba2LM
from repro_torch.serve.arch import (ARCHITECTURES, CompositeStrategy,
                                    ConstantStateStrategy, PagedKVStrategy,
                                    build_strategy, resolve)
from repro_torch.serve.engine import Engine, Request
from test_torch_engine import assert_same, drive, preempt_and_compact
from test_torch_ssm import SSM_ARCHS, ssm_pair, states_after_prefill

torch.set_num_threads(1)

TOL = 1e-4
DISCIPLINE = {"mamba2_370m": (Mamba2LM, ConstantStateStrategy, ("state",)),
              "rwkv6_7b": (RWKVLM, ConstantStateStrategy, ("state",)),
              "zamba2_2p7b": (Zamba2LM, CompositeStrategy, ("kv", "state"))}
#: one sequence's state block at the published widths, float32 elements
STATE_ELEMS = {"mamba2_370m": 48 * (3 * (2048 + 256) + 32 * 64 * 128),
               "rwkv6_7b": 32 * (2 * 4096 + 64 * 64 * 64),
               "zamba2_2p7b": 54 * (3 * (5120 + 128) + 80 * 64 * 64)}


@pytest.fixture(scope="module", params=SSM_ARCHS)
def pair(request):
    return ssm_pair(request.param)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS + ["gemma_2b"])
def test_registry_resolves_each_family(arch):
    model = build_model(get_config(arch).reduced())
    row = resolve(model)
    strategy, suffixes = ((PagedKVStrategy, ("kv",)) if arch == "gemma_2b"
                          else DISCIPLINE[arch][1:])
    assert row.served and row.strategy is strategy
    assert row.pool_suffixes == suffixes
    strat = build_strategy(model, arena=Arena(), slots=2, max_seq=32,
                           num_blocks=8, pool_prefix="p-", device="cpu")
    assert type(strat) is strategy
    assert strat.pool_classes == ["p-" + s for s in suffixes]
    growing = {"kv"} & set(suffixes)
    assert strat.growing_classes == frozenset("p-" + s for s in growing)
    assert strat.supports_prefix_sharing == (arch == "gemma_2b")


class _Stub:
    def __init__(self, cfg):
        self.cfg = cfg


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_audio_and_vision_stay_refused(family):
    """Both families build models now; serving them stays refused, as in
    the reference for whisper (its row is unserved) and by the port's
    contract for the VLM (the engine passes no image embeddings)."""
    rows = {r.key: r for r in ARCHITECTURES}
    assert not rows["audio"].served
    assert all(rows[k].served for k in ("dense", "mamba2", "hybrid", "rwkv6"))
    arch = {"audio": "whisper_tiny", "vlm": "internvl2_1b"}[family]
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    with pytest.raises(NotImplementedError):
        build_strategy(_Stub(cfg), arena=Arena(), slots=2, max_seq=32,
                       num_blocks=8, device="cpu")
    with pytest.raises(NotImplementedError):
        build_strategy(build_model(cfg), arena=Arena(), slots=2, max_seq=32,
                       num_blocks=8, device="cpu")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_published_models_build(arch):
    cfg = get_config(arch)
    model = build_model(cfg)
    assert type(model) is DISCIPLINE[arch][0]
    assert model.state_elems == STATE_ELEMS[arch]
    assert resolve(model).strategy is DISCIPLINE[arch][1]
    if arch == "zamba2_2p7b":
        kv = model.kv_config(max_seq=384, batch=4)
        assert (kv.num_layers, kv.kv_heads, kv.head_dim) == (9, 32, 80)


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------
def test_decode_matches_jax(pair):
    """A prefill of rows of 16, 11 and 5 tokens, then 6 greedy decode
    steps from each row's own last token: logits within TOL of JAX's at
    every step, identical tokens, and the state rows equal at the end."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.RandomState(5).randint(2, cfg.vocab_size, (3, 16))
    lens = np.array([16, 11, 5], np.int32)
    (jl, jst), (tl, tst) = states_after_prefill(pair, toks, lens)
    _close(tl, jl)
    nxt = np.asarray(jl).argmax(-1)
    assert np.array_equal(tl.argmax(-1).numpy(), nxt)
    for _ in range(6):
        jl, jst = jm.decode_step(jp, jnp.asarray(nxt), jst)
        tl, tst = tm.decode_step(tp, torch.from_numpy(nxt), tst)
        _close(tl, jl)
        nxt = np.asarray(jl).argmax(-1)
        assert np.array_equal(tl.argmax(-1).numpy(), nxt)
    if cfg.family == "hybrid":
        _close(tm.state_to_rows(tst.conv, tst.ssd),
               jm.state_to_rows(jst.conv, jst.ssd))
        _close(tst.kv.k_pool, jst.kv.k_pool)
        assert np.array_equal(tst.kv.seq_lens.numpy(),
                              np.asarray(jst.kv.seq_lens))
    else:
        _close(tm.state_to_rows(tst), jm.state_to_rows(jst))


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------
def _state_ledger(eng, state):
    """Hook: the state class's swap ledger after every step (the
    composite's primary store is its KV class's)."""
    st = eng.strategy.state_store.stats
    state.setdefault("state_ledger", []).append(
        (st.swap_outs, st.swap_ins, st.swap_out_bytes, st.swap_in_bytes))


def _hooks(*fns):
    def hook(eng, state):
        for fn in fns:
            fn(eng, state)
    return hook


def test_engine_matches_jax(pair):
    """Five requests of mixed lengths on 2 slots and a tight pool: one
    forced LIFO preemption after step 3 (the whole state block to the
    host tier and back), one compaction of the fragmented state pool
    (``block_copy``'s plain version on the CPU); tokens, preemptions,
    compactions, steps and the swap ledger after every step equal the
    JAX engine's, and both Arenas end quiescent."""
    cfg = pair[4]
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(2, cfg.vocab_size, size=int(rng.randint(5, 20))), n)
            for n in (8, 5, 6, 4, 7)]
    hybrid = cfg.family == "hybrid"
    fns = [preempt_and_compact(3)] + ([_state_ledger] if hybrid else [])
    kw = dict(slots=2, max_seq=48, num_blocks=10 if hybrid else 4)
    j = drive("jax", pair, reqs, kw, hook=_hooks(*fns))
    t = drive("torch", pair, reqs, kw, hook=_hooks(*fns))
    assert_same(j, t)
    assert len(t["tokens"]) == 5 and t["preemptions"] >= 1
    assert t["state"]["forced"] and t["state"]["moved"] > 0
    assert t["ledger"][-1][0] >= 1 and t["ledger"][-1][1] >= 1
    if hybrid:
        assert j["state"]["state_ledger"] == t["state"]["state_ledger"]
        assert t["state"]["state_ledger"][-1][0] >= 1
    block = 4 * pair[2].state_elems            # float32 state block
    ledger = t["state"]["state_ledger"] if hybrid else t["ledger"]
    assert ledger[-1][2] == ledger[-1][0] * block


def _engine(pair, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("num_blocks", 24)
    return Engine(pair[2], pair[3], eos_id=-1, prefill_budget=None,
                  device="cpu", **kw)


def test_preempt_resume_is_exact(pair):
    """One sequence preempted after 3 steps: the resumed run's tokens
    equal the uninterrupted run's, the whole recurrent state having made
    one host round trip of exactly one state block."""
    cfg = pair[4]
    pr = np.random.RandomState(5).randint(2, cfg.vocab_size, size=9)
    ref = _engine(pair)
    ref.submit(Request(rid=0, prompt=pr.copy(), max_new=8))
    ref.run(100)
    eng = _engine(pair)
    eng.submit(Request(rid=0, prompt=pr.copy(), max_new=8))
    for _ in range(3):
        eng.step()
    eng.preempt_latest()
    eng.sync_transfers()
    mgr = getattr(eng.strategy, "state_mgr", eng.strategy.mgr)
    assert len(mgr.swapped) == 1
    eng.run(100)
    assert eng.preemptions == 1
    assert eng.done[0].generated == ref.done[0].generated
    store = getattr(eng.strategy, "state_store", eng.strategy.store)
    assert store.stats.swap_out_bytes == store.stats.swap_in_bytes \
        == 4 * pair[2].state_elems
    eng.arena.assert_quiescent()


def _run(eng, prompts, max_new=6, preempt_at=3):
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr.copy(), max_new=max_new))
    forced = False
    while (eng.sched.has_work or eng.running) and eng.steps < 400:
        eng.step()
        eng.check_consistency()
        if eng.steps == preempt_at and eng.running and not forced:
            eng.preempt_latest()
            forced = True
    eng.sync_transfers()
    assert forced
    return {r.rid: list(r.generated) for r in eng.done}


def test_resident_matches_eager_across_preemption(pair):
    """Per-request token identity, resident vs eager decode, across a
    forced preemption round trip, with fewer host uploads on the
    resident path (``check_consistency`` audits the device rows each
    step)."""
    cfg = pair[4]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(2, cfg.vocab_size, size=int(rng.randint(6, 20)))
               for _ in range(4)]
    got, uploads = {}, {}
    for resident in (True, False):
        eng = _engine(pair, resident_tables=resident)
        got[resident] = _run(eng, prompts)
        uploads[resident] = eng.stats["host_uploads"]
        assert len(eng.done) == len(prompts)
        assert eng.stats["resident_tables"] is resident
        assert not eng.running
        eng.arena.assert_quiescent()
    assert got[True] == got[False]
    assert uploads[True] < uploads[False]


# ---------------------------------------------------------------------------
# three disciplines, one Arena
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def families():
    """One reduced model per discipline: paged / constant / composite."""
    out = {}
    for key, arch in (("dense", "gemma_2b"), ("ssm", "mamba2_370m"),
                      ("hybrid", "zamba2_2p7b")):
        model = build_model(get_config(arch).reduced())
        out[key] = (model, model.init(seed=len(out), device="cpu"))
    return out


def _make(model, params, arena, prefix):
    return Engine(model, params, slots=2, max_seq=64, num_blocks=24,
                  eos_id=-1, prefill_budget=None, arena=arena,
                  pool_prefix=prefix, device="cpu")


def test_mixed_disciplines_share_one_arena(families):
    """A transformer, a mamba2 and a zamba2 served concurrently from ONE
    Arena: per-family tokens identical to each engine alone in a private
    arena, despite forced preemption and resume through all three
    disciplines' pool classes mid-run; quiescent at drain."""
    prompts = {k: [np.random.RandomState(100 + i).randint(
        2, 500, size=int(n)) for n in (9, 14, 17)]
        for i, k in enumerate(("dense", "ssm", "hybrid"))}
    ref = {}
    for key, (model, params) in families.items():
        eng = _make(model, params, None, "")
        for i, pr in enumerate(prompts[key]):
            eng.submit(Request(rid=i, prompt=pr.copy(), max_new=5))
        eng.run(200)
        ref[key] = {r.rid: list(r.generated) for r in eng.done}
        eng.arena.assert_quiescent()

    arena = Arena()
    engines = {}
    for key, prefix in (("dense", ""), ("ssm", "m2-"), ("hybrid", "zb-")):
        engines[key] = _make(*families[key], arena, prefix)
        for i, pr in enumerate(prompts[key]):
            engines[key].submit(Request(rid=i, prompt=pr.copy(), max_new=5))
    for _ in range(3):
        for e in engines.values():
            e.step()
    for e in engines.values():
        e.preempt_latest()
        e.sync_transfers()
    assert len(engines["ssm"].mgr.swapped) >= 1
    assert len(engines["ssm"].store) >= 1          # state payload on host
    assert len(engines["hybrid"].mgr.swapped) >= 1
    assert len(engines["hybrid"].strategy.state_mgr.swapped) >= 1
    assert len(engines["dense"].mgr.swapped) >= 1
    for step in range(200):
        if all(not (e.sched.has_work or e.running) for e in engines.values()):
            break
        if step == 2:
            for e in engines.values():
                e.preempt_latest()
        for e in engines.values():
            e.step()
            e.check_consistency()
    for key, eng in engines.items():
        eng.sync_transfers()
        assert eng.preemptions >= 1
        assert {r.rid: list(r.generated) for r in eng.done} == ref[key], key
        assert eng.stats["swap_outs"] >= 1 and eng.stats["swap_ins"] >= 1
    stats = arena.stats()
    for cls in ("kv", "m2-state", "zb-kv", "zb-state"):
        assert stats[cls].num_used == stats[cls].pinned   # only sinks left
    arena.assert_quiescent()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_launcher_runs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--trace",
                 "prefixheavy", "--prefill-budget", "none"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "served 3/3 requests on cpu" in out
    assert "prefix-share hits 0" in out
