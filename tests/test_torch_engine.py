"""The PyTorch serving engine against the JAX engine, workload by workload.

Both engines serve reduced gemma-2b (float32, CPU) with the same
parameters (the JAX ``init``, converted through numpy) and the same
scripted requests, with ``prefill_budget=None`` so every scheduling
decision is deterministic.  Per workload the two must agree exactly on:
the generated tokens of every request, the number of preemptions, the
swap ledger after every step (swap-outs, swap-ins and their bytes), the
prefix hits and ``prefill_tokens_saved``, COW copies, compactions and
the step count.  Both end quiescent.

The workloads are those of ``tests/test_serve_stack.py``: the scripted
mixed workload (forced preemption, forks, a mid-flight compaction), the
overlapped-vs-drained transfer schedule under growth pressure, the COW
barrier under pool exhaustion, and LIFO resume from a speculative
prefetch.  The scripted workload and the growth-pressure schedule also
run on reduced ``qwen3_moe_30b_a3b`` (MoE, qk-norm, suffix prefill) and
``deepseek_v2_lite_16b`` (MLA latent pool, MoE with shared experts, a
dense layer 0; a forked prompt is recomputed, so no prefill token is
saved).
"""

import numpy as np
import pytest
import torch
import jax

from repro.configs.base import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params
from repro_torch.serve.engine import Engine, Request

torch.set_num_threads(1)


def make_pair(arch="gemma_2b", seed=0):
    """(jax model, jax params, torch model, torch params, cfg)."""
    jcfg = jget_config(arch).reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced()
    tp = convert_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp, cfg


def drive(pkg, pair, requests, engine_kw, *, hook=None, source=None,
          max_steps=400):
    """Serve ``requests`` [(prompt, max_new)] (or a trace ``source``
    factory) on the ``pkg`` ("jax" | "torch") engine; returns the
    comparable record."""
    jm, jp, tm, tp, cfg = pair
    if pkg == "jax":
        eng = JEngine(jm, jp, eos_id=-1, prefill_budget=None, **engine_kw)
        req_cls = JRequest
    else:
        eng = Engine(tm, tp, eos_id=-1, prefill_budget=None, device="cpu",
                     **engine_kw)
        req_cls = Request
    for rid, (prompt, max_new) in enumerate(requests):
        eng.submit(req_cls(rid=rid, prompt=prompt.copy(), max_new=max_new))
    src = source(pkg) if source is not None else None
    ledger, state = [], {}
    while eng.steps < max_steps:
        if src is not None:
            for req in src.poll(float(eng.steps)):
                eng.submit(req)
        if not (eng.sched.has_work or eng.running):
            if src is None or not src.has_more:
                break
        eng.step()
        eng.check_consistency()
        if hook is not None:
            hook(eng, state)
        st = eng.store.stats
        ledger.append((st.swap_outs, st.swap_ins, st.swap_out_bytes,
                       st.swap_in_bytes))
    eng.sync_transfers()
    assert not eng.running and not eng.sched.has_work
    eng.arena.assert_quiescent()
    return {"tokens": {r.rid: list(r.generated) for r in eng.done},
            "preemptions": eng.preemptions, "ledger": ledger,
            "prefix_hits": eng.prefix_hits,
            "prefill_tokens_saved": eng.prefill_tokens_saved,
            "cow_copies": eng.cow_copies,
            "compactions": eng.arena.compactions, "steps": eng.steps,
            "state": state, "engine": eng}


def assert_same(a, b):
    for key in ("tokens", "preemptions", "ledger", "prefix_hits",
                "prefill_tokens_saved", "cow_copies", "compactions",
                "steps"):
        assert a[key] == b[key], (key, a[key], b[key])


def both(pair, requests, engine_kw, **kw):
    j = drive("jax", pair, requests, engine_kw, **kw)
    t = drive("torch", pair, requests, engine_kw, **kw)
    assert_same(j, t)
    return j, t


def preempt_and_compact(at, compact=True):
    """Hook: one forced LIFO preemption after step ``at``, then one
    mid-flight compaction as soon as the pool is fragmented."""
    def hook(eng, state):
        if eng.steps == at and eng.running and not state.get("forced"):
            eng.preempt_latest()
            state["forced"] = True
        if (compact and state.get("forced") and not state.get("moved")
                and eng.arena.fragmentation(eng.mgr.pool_class) > 0):
            state["moved"] = eng.compact_now()
            eng.check_consistency()
    return hook


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_scripted_workload_matches_jax(pair):
    cfg = pair[4]
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, size=16)
    reqs = [(base, 10), (rng.randint(2, cfg.vocab_size, size=9), 6),
            (base, 6),
            (np.concatenate([base, rng.randint(2, cfg.vocab_size, size=5)]),
             6),
            (rng.randint(2, cfg.vocab_size, size=5), 6)]
    j, t = both(pair, reqs, dict(slots=3, max_seq=64, num_blocks=20,
                                 watermark=1),
                hook=preempt_and_compact(3))
    assert len(t["tokens"]) == 5
    assert t["state"]["forced"] and t["state"]["moved"] > 0
    assert t["preemptions"] >= 1 and t["prefix_hits"] >= 2
    assert t["compactions"] >= 1 and t["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("overlap", [True, False])
def test_overlapped_schedule_matches_jax(pair, overlap):
    """Growth-pressure preemptions under the double-buffered schedule
    and under drain(): each matches the JAX engine on the same schedule,
    and the two schedules decode the same tokens."""
    rngl = np.random.RandomState(3)
    reqs = [(rngl.randint(2, 100, size=n), 12) for n in (8, 7, 6)]
    kw = dict(slots=2, max_seq=32, num_blocks=6, overlap_transfers=overlap)
    j, t = both(pair, reqs, kw)
    assert t["preemptions"] > 0
    tr = t["engine"].transfers.stats
    if overlap:
        assert tr.overlapped["d2h"] >= 1
    else:
        assert all(v == 0 for v in tr.overlapped.values())
    assert tr.overlapped == j["engine"].transfers.stats.overlapped


def test_cow_barrier_under_pool_exhaustion_matches_jax(pair):
    rng = np.random.RandomState(0)
    parent = rng.randint(2, 100, size=20)
    reqs = [(parent, 4), (rng.randint(2, 100, size=14), 4),
            (rng.randint(2, 100, size=14), 4)]
    late = (parent[:12].copy(), 4)

    def hook(eng, state):
        if eng.steps == 2 and not state.get("late"):
            req_cls = Request if isinstance(eng, Engine) else JRequest
            eng.submit(req_cls(rid=3, prompt=late[0].copy(),
                               max_new=late[1]))
            state["late"] = True

    j, t = both(pair, reqs, dict(slots=4, max_seq=32, num_blocks=10),
                hook=hook, max_steps=300)
    assert len(t["tokens"]) == 4 and t["prefix_hits"] >= 1


def test_lifo_resume_from_completed_prefetch_matches_jax(pair):
    rngl = np.random.RandomState(3)
    shapes = [(8, 48), (8, 48), (8, 8), (8, 40)]
    reqs = [(rngl.randint(2, 100, size=pl), mn) for pl, mn in shapes]
    j, t = both(pair, reqs, dict(slots=3, max_seq=64, num_blocks=20,
                                 watermark=2),
                hook=preempt_and_compact(34, compact=False))
    eng = t["engine"]
    assert eng.prefetches >= 1 and eng.prefetch_hits >= 1
    assert eng.prefetch_cancels == 0
    assert eng.transfers.stats.overlapped["h2d"] >= 1
    assert (eng.prefetches, eng.prefetch_hits) == (
        j["engine"].prefetches, j["engine"].prefetch_hits)


# ---------------------------------------------------------------------------
# MoE decoders
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["qwen3_moe_30b_a3b",
                                        "deepseek_v2_lite_16b"])
def moe_pair(request):
    return make_pair(request.param)


def test_moe_scripted_workload_matches_jax(moe_pair):
    """The scripted mixed workload (forks, a forced preemption with
    swap-out and swap-in, a mid-flight compaction) on an MoE decoder."""
    cfg = moe_pair[4]
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, size=16)
    reqs = [(base, 10), (rng.randint(2, cfg.vocab_size, size=9), 6),
            (base, 6),
            (np.concatenate([base, rng.randint(2, cfg.vocab_size, size=5)]),
             6),
            (rng.randint(2, cfg.vocab_size, size=5), 6)]
    j, t = both(moe_pair, reqs, dict(slots=3, max_seq=64, num_blocks=20,
                                     watermark=1),
                hook=preempt_and_compact(3))
    eng = t["engine"]
    assert len(t["tokens"]) == 5 and t["state"]["forced"]
    assert t["preemptions"] >= 1 and t["prefix_hits"] >= 2
    assert t["compactions"] >= 1
    outs, ins, out_b, in_b = t["ledger"][-1]
    assert outs >= 1 and ins >= 1 and out_b == in_b > 0
    if eng.mgr.config.latent:               # MLA recomputes a forked prompt
        assert not eng.suffix_prefill and t["prefill_tokens_saved"] == 0
    else:
        assert eng.suffix_prefill and t["prefill_tokens_saved"] > 0


def test_moe_growth_pressure_matches_jax(moe_pair):
    """Growth-pressure preemptions under the double-buffered schedule."""
    rngl = np.random.RandomState(3)
    reqs = [(rngl.randint(2, 100, size=n), 12) for n in (8, 7, 6)]
    j, t = both(moe_pair, reqs, dict(slots=2, max_seq=32, num_blocks=6))
    assert t["preemptions"] > 0
