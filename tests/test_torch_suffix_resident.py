"""Suffix-only prefill and the resident decode path, PyTorch vs JAX.

The workloads of the suffix-prefill tests in ``tests/test_serve_stack.py``
(fork depth two, partial-tail aliasing, gemma2-style sliding windows with
softcaps, the COW barrier under exhaustion with a preemption round trip)
and of the paged-family tests in ``tests/test_resident_decode.py``
(resident vs eager across preemption and compaction, a fork-heavy
``prefixheavy`` arrival trace, upload-free steady state).  Each is served
by both engines and held to the same tokens, preemptions, per-step swap
ledger and ``prefill_tokens_saved`` (see ``test_torch_engine.drive``).
"""

import numpy as np
import pytest
import torch

from repro.serve.traffic import make_trace as jmake_trace
from repro_torch.serve.traffic import make_trace
from test_torch_engine import both, drive, make_pair, preempt_and_compact

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _suffix_both(pair, prompts, max_new, **kw):
    """Both engines with suffix prefill on, plus the torch engine with it
    off: the two torch modes decode the same tokens."""
    reqs = list(zip(prompts, max_new))
    on, ton = both(pair, reqs, dict(suffix_prefill=True, **kw))
    off = drive("torch", pair, reqs, dict(suffix_prefill=False, **kw))
    assert ton["tokens"] == off["tokens"]
    assert off["prefill_tokens_saved"] == 0
    return ton


def test_suffix_fork_depth_matches_jax(pair):
    cfg = pair[4]
    rng = np.random.RandomState(1)
    base = rng.randint(2, cfg.vocab_size, size=16)
    mid = np.concatenate([base, rng.randint(2, cfg.vocab_size, size=8)])
    top = np.concatenate([mid, rng.randint(2, cfg.vocab_size, size=5)])
    t = _suffix_both(pair, [base, mid, top], [10, 8, 6], slots=3,
                     max_seq=64, num_blocks=24)
    assert t["prefill_tokens_saved"] == 40


def test_suffix_partial_tail_alias_matches_jax(pair):
    cfg = pair[4]
    rng = np.random.RandomState(2)
    parent = rng.randint(2, cfg.vocab_size, size=20)
    longer = np.concatenate([parent, rng.randint(2, cfg.vocab_size, size=6)])
    t = _suffix_both(pair, [parent, parent[:12].copy(), longer], [10, 6, 6],
                     slots=3, max_seq=64, num_blocks=24)
    assert t["prefill_tokens_saved"] == 8 + 16


def test_suffix_sliding_window_softcap_matches_jax():
    pair2 = make_pair("gemma2_27b")
    cfg = pair2[4]
    assert cfg.local_window and cfg.attn_softcap
    rng = np.random.RandomState(3)
    base = rng.randint(2, cfg.vocab_size, size=24)
    child = np.concatenate([base, rng.randint(2, cfg.vocab_size, size=7)])
    t = _suffix_both(pair2, [base, child], [8, 8], slots=2, max_seq=64,
                     num_blocks=24)
    assert t["prefill_tokens_saved"] == 24


def test_suffix_cow_exhaustion_resume_matches_jax(pair):
    cfg = pair[4]
    rng = np.random.RandomState(4)
    parent = rng.randint(2, cfg.vocab_size, size=20)
    reqs = [(parent, 4), (rng.randint(2, cfg.vocab_size, size=14), 4),
            (parent[:12].copy(), 6)]
    for flag in (True, False):
        j, t = both(pair, reqs, dict(slots=4, max_seq=32, num_blocks=10,
                                     suffix_prefill=flag),
                    hook=preempt_and_compact(2, compact=False), max_steps=300)
        assert t["state"]["forced"] and len(t["tokens"]) == 3
        if flag:
            assert t["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("resident", [True, False])
def test_resident_and_eager_match_jax_across_preemption(pair, resident):
    """Forced preemption, a COW fork and a compaction on the resident
    (delta-synced) and eager (full rebuild) decode paths."""
    cfg = pair[4]
    rng = np.random.RandomState(23)
    base = rng.randint(2, cfg.vocab_size, size=16)
    prompts = [base, rng.randint(2, cfg.vocab_size, size=9), base,
               np.concatenate([base, rng.randint(2, cfg.vocab_size, size=5)]),
               rng.randint(2, cfg.vocab_size, size=5)]
    reqs = list(zip(prompts, [10, 6, 6, 6, 6]))
    j, t = both(pair, reqs, dict(slots=3, max_seq=64, num_blocks=20,
                                 watermark=1, resident_tables=resident),
                hook=preempt_and_compact(3))
    assert t["state"]["moved"] > 0
    eng, jeng = t["engine"], j["engine"]
    assert eng.host_uploads == jeng.host_uploads
    assert eng.table_rows_updated == jeng.table_rows_updated
    assert eng.table_sync_bytes == jeng.table_sync_bytes


def test_resident_prefixheavy_trace_matches_jax(pair):
    cfg = pair[4]

    def source(pkg):
        mk = jmake_trace if pkg == "jax" else make_trace
        return mk("prefixheavy", 8, cfg.vocab_size, seed=3, mean_gap=2.0,
                  tenants=2, max_new=6, prompt_cap=24)

    j, t = both(pair, [], dict(slots=3, max_seq=64, num_blocks=24),
                source=source, max_steps=10_000)
    assert len(t["tokens"]) == 8 and t["prefix_hits"] > 0


def test_resident_steady_state_stops_uploading(pair):
    cfg = pair[4]
    pr = np.random.RandomState(5).randint(2, cfg.vocab_size, size=8)
    j, t = both(pair, [(pr, 24)], dict(slots=1, max_seq=64, num_blocks=24))
    eng = t["engine"]
    assert eng.host_uploads == j["engine"].host_uploads
    assert eng.stats["host_uploads_per_step"] < 1.0
