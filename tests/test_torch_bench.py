"""The port's serving benchmarks against the reference's.

* ``repro_torch.bench.end2end`` (Fig. 5): the reduced row's five layouts
  (paged at 8-64-token blocks, contiguous) hold the same seeded K/V; on
  weights converted from the JAX init, the port's ``decode_step`` logits
  equal the reference's ``decode_step`` on the same pools and tables
  within 1e-4 (float32, both on the CPU: differently ordered sums), the
  layouts equal each other within the bench's 1e-5 of max|logit|, and
  the planted fault (a permuted table) trips that gate.
* ``repro_torch.bench.serve``: with weights converted from the
  reference's init (``benchmarks/bench_serve.py``'s ``_MODEL_CACHE``),
  every counter of the scripted workload and of each ``--smoke`` probe
  (prefetch, suffix, decode path, mixed arch, migrate) equals the
  reference bench's, times left out (``TIME_KEYS``); the arrival trace,
  whose prefill budget follows the wall clock, by its per-request
  tokens.  The reference's functions are loaded from the file and
  called directly, never its ``main``, so nothing is written to the
  working directory.
* ``repro_torch.report``: one ``BENCH_serve.json`` dict renders to the
  same text in both packages.
* ``repro_torch.roofline``: the reference's formulas with the H100's
  constants; ``configs/shapes.py``: the same cells.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import report as jreport
from repro import roofline as jroofline
from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jget_config
from repro.core.paged_kv import PagedKVCache as JCache
from repro.models.api import build_model as jbuild_model
from repro_torch import report, roofline
from repro_torch.bench import end2end
from repro_torch.bench import serve as bserve
from repro_torch.bench.common import ResultMismatch
from repro_torch.configs import shapes
from repro_torch.configs.base import get_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import convert_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4
#: report keys that hold wall-clock readings
TIME_KEYS = frozenset({"wall_s", "tokens_per_s", "phase_time_s",
                       "migrate_wall_s", "tenant_latency",
                       "latency_histogram", "trace_tokens_per_s"})


def _converted(jcfg, jparams, name, reduced=True):
    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, build_model(cfg), convert_params(np_params, cfg,
                                                 device="cpu")


# ---------------------------------------------------------------------------
# end2end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def e2e_pair():
    jcfg = jget_config("gemma_2b").reduced()
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    _, tm, tp = _converted(jcfg, jp, "gemma_2b")
    return jm, jp, tm, tp


def test_end2end_layouts_match_jax_decode_step(e2e_pair):
    """Each layout of the reduced row, pools and tables handed to both
    packages: the port's logits equal the JAX ``decode_step``'s within
    1e-4, and its appended pools equal the reference's returned ones."""
    jm, jp, tm, tp = e2e_pair
    _, B, max_seq, ctx = end2end.ROWS["reduced"]
    tokens = end2end.step_tokens(tm.cfg, B, "cpu").numpy()
    caches = end2end.layouts(tm, B, max_seq, ctx, "cpu")
    assert [n for n, _ in caches] == [f"decode_paged_bt{bt}" for bt in
                                      end2end.BLOCK_TOKENS] + \
        ["decode_contiguous"]
    for name, c in caches:
        kvcfg = dataclasses.replace(
            jm.kv_config(max_seq=max_seq, batch=B),
            block_tokens=c.config.block_tokens,
            num_blocks=c.config.num_blocks,
            max_blocks_per_seq=c.config.max_blocks_per_seq)
        jc = JCache(jnp.asarray(c.k_pool.numpy()),
                    jnp.asarray(c.v_pool.numpy()),
                    jnp.asarray(c.block_tables.numpy()),
                    jnp.asarray(c.seq_lens.numpy()), kvcfg)
        jl, jc = jm.decode_step(jp, jnp.asarray(tokens), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tokens), c)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(tc.k_pool.numpy(), np.asarray(jc.k_pool),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        assert np.array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))


def test_end2end_cli_gates_layouts_and_trips_the_fault(e2e_pair, capsys):
    """``python -m repro_torch.bench.end2end --device cpu --rows reduced``
    prints the reference's five row names; the layouts agree within
    ``F32_LOGIT_TOL`` of max|logit| and the permuted table does not."""
    rows = end2end.main(["--device", "cpu", "--rows", "reduced"])
    out = capsys.readouterr().out
    names = [line.split(",")[0] for line in out.splitlines()
             if not line.startswith("#")]
    assert names == ["decode_paged_bt8", "decode_paged_bt16",
                     "decode_paged_bt32", "decode_paged_bt64",
                     "decode_contiguous"]
    assert all(r["gap"] <= end2end.F32_LOGIT_TOL for r in rows[:-1])
    assert all(r["us"] > 0 for r in rows[:-1])
    fault = rows[-1]
    assert fault["name"] == "fault_permuted_table" and fault["trips"]
    assert fault["gap"] > 100 * end2end.F32_LOGIT_TOL
    # the gate on the JAX-converted weights: same verdicts
    jm, jp, tm, tp = e2e_pair
    _, B, max_seq, ctx = end2end.ROWS["reduced"]
    rows = end2end.run_row("reduced", tm, tp, "cpu", B=B, max_seq=max_seq,
                           ctx=ctx, timed=False)
    assert all(r["gap"] <= end2end.F32_LOGIT_TOL for r in rows[:-1])
    assert rows[-1]["trips"]


def test_end2end_gate_refuses_a_fault_that_passes(e2e_pair, monkeypatch):
    """A planted fault that moves nothing (the table left as it is) must
    make the bench fail: the gate has to see the fault it plants."""
    _, _, tm, tp = e2e_pair
    _, B, max_seq, ctx = end2end.ROWS["reduced"]
    monkeypatch.setattr(end2end, "permuted", lambda cache: cache)
    with pytest.raises(ResultMismatch, match="planted fault"):
        end2end.run_row("reduced", tm, tp, "cpu", B=B, max_seq=max_seq,
                        ctx=ctx, timed=False)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def _without_times(x):
    if isinstance(x, dict):
        return {k: _without_times(v) for k, v in x.items()
                if k not in TIME_KEYS and k != "groups"}
    return x


@pytest.fixture(scope="module")
def served():
    """The reference bench module, the shared ``--smoke`` args and the
    port's models dict holding the reference's weights, converted."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench_serve", REPO / "benchmarks" / "bench_serve.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    args = bserve.parse_args(["--smoke", "--device", "cpu"])
    jcfg, _ = ref.build(args)
    models = {}
    _, _, jp = ref._MODEL_CACHE[bserve.model_key(args)]
    models[bserve.model_key(args)] = _converted(jcfg, jp, args.arch)
    for _, name, _ in bserve.MIXED_FAMILIES:
        key = ("mixed_arch", name, args.seed)
        jcfg = jget_config(name).reduced()
        jm = jbuild_model(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(args.seed))
        ref._MODEL_CACHE[key] = (jcfg, jm, jp)
        models[key] = _converted(jcfg, jp, name)
    return ref, args, models


def test_serve_workload_counters_match_reference(served):
    """The scripted workload with its forced preemption: every counter
    of the report equals the reference engine's, and the ``drain()``
    schedule is token- and swap-byte-identical in both packages."""
    ref, args, models = served
    rep, _, eng, eng2 = bserve.workload_report(args, models)
    rcfg, reng = ref.build(args)
    ref.drive(rcfg, reng, args)
    rcfg2, reng2 = ref.build(args, overlap=False)
    ref.drive(rcfg2, reng2, args)
    st = reng.stats
    for key in ("steps", "decode_tokens", "prefill_tokens",
                "prefill_tokens_saved", "swap_out_bytes", "swap_in_bytes",
                "preemptions", "prefix_hits", "prefetches", "prefetch_hits",
                "prefetch_cancels", "cow_copies", "compactions",
                "blocks_compacted", "watermark_effective", "resident_tables",
                "host_uploads", "table_sync_bytes", "table_rows_updated"):
        assert rep[key] == st[key], key
    blocks = sum(n for _, n, _ in reng.store.stats.out_log)
    per_block = reng.cache.config.swap_nbytes_per_block()
    assert rep["completed"] == len(reng.done) == args.requests
    assert rep["blocks_swapped_out"] == blocks
    assert rep["swap_nbytes_per_block"] == per_block
    assert rep["swap_bytes_per_step"] == round(
        (st["swap_out_bytes"] + st["swap_in_bytes"]) / max(reng.steps, 1), 1)
    assert rep["pool_utilization_final"] == round(st["pool_utilization"], 3)
    assert rep["host_uploads_per_step"] == round(
        st["host_uploads_per_step"], 3)
    assert rep["prefetch_hit_rate"] == round(st["prefetch_hit_rate"], 3)
    assert rep["transfers"] == st["transfers"]
    assert rep["arena"] == _without_times(reng.arena_stats().to_dict())
    assert rep["all_ok"] and rep["overlap_equivalent"]
    assert ({r.rid: list(r.generated) for r in eng.done}
            == {r.rid: list(r.generated) for r in reng.done})
    assert eng2.stats["swap_out_bytes"] == reng2.stats["swap_out_bytes"]
    assert ({r.rid: list(r.generated) for r in eng2.done}
            == {r.rid: list(r.generated) for r in reng2.done})


@pytest.mark.parametrize("probe", ["prefetch_probe", "suffix_probe",
                                   "decode_path_probe", "mixed_arch_probe"])
def test_serve_probe_counters_match_reference(served, probe):
    """Each ``--smoke`` probe's report, times left out, equals the
    reference bench's on the same weights, and its gate holds."""
    ref, args, models = served
    got = getattr(bserve, probe)(args, models)
    want = getattr(ref, probe)(args)
    assert _without_times(got) == _without_times(want)
    gates = {"prefetch_probe": lambda r: r["prefetch_hits"] > 0
             and r["completed"] == 4,
             "suffix_probe": lambda r: r["token_identical"]
             and r["suffix"]["prefill_tokens_saved"] > 0,
             "decode_path_probe": lambda r: r["ok"],
             "mixed_arch_probe": lambda r: r["ok"]}
    assert gates[probe](got)


def test_serve_migrate_probe_matches_reference(served, tmp_path):
    """Live migration and the disaggregated prefill: the report's
    counters, the snapshot's file size among them, equal the
    reference's, the gate holds, and the snapshot's directory is gone."""
    ref, args, models = served
    got = bserve.migrate_probe(args, models, str(tmp_path))
    want = ref.migrate_probe(args)
    assert got["ok"] and want["ok"]
    assert _without_times(got) == _without_times(want)
    assert not list(tmp_path.iterdir())


def test_serve_trace_tokens_match_reference(served):
    """The poisson arrival trace through ``Engine.serve`` with the
    adaptive budget: the same arrivals and per-request tokens."""
    from repro.serve.traffic import make_trace as jmake_trace
    import argparse

    ref, args, models = served
    eng, _, n = bserve.trace_run(args, models)
    pargs = argparse.Namespace(**{**vars(args), "prefill_budget": "auto"})
    rcfg, reng = ref.build(pargs)
    source = jmake_trace(args.trace, args.requests, rcfg.vocab_size,
                         seed=args.seed, mean_gap=args.trace_gap,
                         tenants=args.trace_tenants, max_new=args.max_new,
                         prompt_cap=min(24, args.max_seq // 2),
                         shared_frac=0.25)
    assert n == len(source) == args.requests
    reng.serve(source, max_steps=100_000)
    assert len(eng.done) == len(reng.done) == n
    assert ({r.rid: list(r.generated) for r in eng.done}
            == {r.rid: list(r.generated) for r in reng.done})
    assert sorted(eng.latency_report()) == sorted(reng.latency_report())


def test_serve_smoke_cli_passes_every_gate(served, tmp_path, capsys):
    """``python -m repro_torch.bench.serve --smoke --device cpu`` on the
    converted weights: exit 0, ``all_ok`` true, the three JSON files in
    ``out_dir``; and the report renders to the same tables in both
    ``report`` modules."""
    _, _, models = served
    rep = bserve.main(["--smoke", "--device", "cpu"], models=models,
                      out_dir=str(tmp_path))
    assert rep["all_ok"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [bserve.OUT_JSON, bserve.OUT_TRANSFERS, bserve.OUT_MIGRATE])
    assert "all_ok=True" in capsys.readouterr().out
    for name in (bserve.OUT_JSON, bserve.OUT_MIGRATE):
        path = str(tmp_path / name)
        report.main(path)
        port_text = capsys.readouterr().out
        jreport.main(path)
        assert port_text == capsys.readouterr().out
        assert "n/a" not in port_text.split("### Cross-process")[-1]


# ---------------------------------------------------------------------------
# report, roofline, shapes
# ---------------------------------------------------------------------------
def test_report_tables_match_reference_on_old_snapshots():
    """Sections missing from a snapshot render as "n/a" in both."""
    doc = {"arena": {"classes": {"kv": {
        "num_blocks": 8, "num_used": 3, "num_free": 5, "pinned": 1,
        "host_blocks": 2, "refcount_histogram": [5, 2, 1],
        "fragmentation": 0.25, "table_locality": 0.5,
        "blocks_by_owner": {"1": 2, "2": 1}}}}}
    for fmt in ("fmt_arena_table", "fmt_tenant_latency_table",
                "fmt_family_table", "fmt_decode_path_table",
                "fmt_migrate_table"):
        arg = doc["arena"] if fmt == "fmt_arena_table" else doc
        assert getattr(report, fmt)(arg) == getattr(jreport, fmt)(arg), fmt
    tr = {"enqueued": {"d2h": 2}, "completed": {"d2h": 2},
          "bytes_moved": {"d2h": 64}, "max_pending": 1, "overlapped": 0}
    assert report.fmt_transfer_table(tr) == jreport.fmt_transfer_table(tr)


def test_report_refuses_dryrun_rows(tmp_path):
    path = tmp_path / "dryrun_report.jsonl"
    path.write_text('{"arch": "gemma_2b"}\n')
    assert report.load(str(path)) == jreport.load(str(path))
    with pytest.raises(SystemExit, match="ROADMAP item 5"):
        report.main(str(path))


@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_moe_30b_a3b",
                                  "deepseek_v2_lite_16b"])
def test_roofline_terms_follow_the_reference_formulas(arch):
    """``model_flops_for`` equals the reference's for every shape, and
    each ``Roofline`` term is the reference's with the H100's constants
    substituted for its chip's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name in shapes.SHAPES:
        assert roofline.model_flops_for(cfg, shapes.SHAPES[name]) == \
            jroofline.model_flops_for(jcfg, jshapes.SHAPES[name])
    kw = dict(arch=arch, shape="decode_32k", mesh="1", chips=1,
              flops_per_chip=3.1e13, bytes_per_chip=7.7e10,
              coll_bytes_per_chip=0.0, peak_memory_per_chip=6.0e10,
              model_flops=2.9e13)
    got, want = roofline.Roofline(**kw), jroofline.Roofline(**kw)
    scale_c = jroofline.PEAK_FLOPS / roofline.PEAK_FLOPS
    scale_m = jroofline.HBM_BW / roofline.HBM_BW
    assert got.t_compute == pytest.approx(want.t_compute * scale_c)
    assert got.t_memory == pytest.approx(want.t_memory * scale_m)
    assert got.t_collective == want.t_collective == 0.0
    assert got.t_bound == max(got.t_compute, got.t_memory)
    assert got.bottleneck == ("compute" if got.t_compute > got.t_memory
                              else "memory")
    assert got.flops_utilization == want.flops_utilization
    assert got.roofline_fraction == pytest.approx(
        kw["model_flops"] / roofline.PEAK_FLOPS / got.t_bound)
    row, jrow = got.row(), want.row()
    scaled = {"t_compute_s": scale_c, "t_memory_s": scale_m}
    for key, value in row.items():
        if key in scaled:
            assert value == pytest.approx(jrow[key] * scaled[key]), key
        elif key not in ("bottleneck", "roofline_fraction"):
            assert value == jrow[key], key
    assert row["bottleneck"] == got.bottleneck
    with pytest.raises(ValueError, match="ROADMAP item 2"):
        dataclasses.replace(got, coll_bytes_per_chip=1.0).t_collective


def test_roofline_bound_is_the_larger_time():
    assert roofline.bound(3.35e9, 0.0, torch.bfloat16) == (1.0, "bytes")
    ms, by = roofline.bound(1.0, 989e9, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(1.0, 67e9, torch.float32)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert (roofline.PEAK_FLOPS, roofline.F32_FLOPS, roofline.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


def test_shapes_cells_equal_the_reference():
    assert shapes.all_cells() == jshapes.all_cells()
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
