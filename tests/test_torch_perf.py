"""The hill-climb over variants (``repro_torch.perf``) and the dry run's
``build_cell`` knobs.

* ``perf.VARIANTS`` are the reference's 14, cell for cell and name for
  name, with the same transforms (the configs they make are equal
  field for field).
* ``run_variant`` on a 2 x 2 placeholder mesh for a reduced cut of each
  of the three cells (``reduced()`` composed into the variant's
  transform, the cell's shape cut in ``SHAPES``) gives an ``ok`` row for every variant, under the
  reference's keys plus ``cell``, ``variant`` and ``hypothesis``; the
  three Qwen3 variants with no transform give the baseline's row; the
  DeepSeek ``latent_tp`` rows bill the two split-latent kernels and no
  #7; ``main`` skips what already has an ``ok`` row.
* The reference's variants set no rules, and the port's have none: its
  steps take the default rules, and ``build_cell``'s train cell remats
  with ZeRO-1 as the reference's dry run lowers it.
* Full-width ``deepseek_v2_lite_16b/decode_32k`` on the 16 x 16
  placeholder mesh, built without a trace: under ``latent_tp`` rank 0's
  pools are ``(L, NB, BT, 32)`` (its lora lanes) and ``(L, NB, BT, 64)``
  (the rope stream), under the baseline ``(L, NB, BT, 576)``; traced,
  the two rows' peaks differ by the rank's pieces: the pools' bytes
  saved, less the query projections that the split layout replicates
  (a serving rank's parameter pieces count at their own size, not at
  their whole parameter's).
"""

import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro_torch import perf
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import placeholder_mesh

torch.set_num_threads(1)

SMALL = {"train_4k": InputShape("train_4k", 32, 4, "train"),
         "decode_32k": InputShape("decode_32k", 64, 4, "decode")}
#: the row's keys that depend on the run, not on the account
_RUN_KEYS = {"variant", "hypothesis", "t_total_s", "t_compile_s",
             "t_lower_s"}


def _reference_variants():
    """(cell, name, cfg_transform, rules) of the reference's ``VARIANTS``,
    read from its source: importing ``repro.perf`` would set
    ``XLA_FLAGS`` in this process.  Its config helpers are executed
    alone and each variant's transform expression evaluated over them."""
    tree = ast.parse((Path(jbase.__file__).parents[1] / "perf.py")
                     .read_text())
    ns = {"dataclasses": dataclasses}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("_"):
            exec(compile(ast.Module([node], []), "perf.py", "exec"), ns)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "Variant":
            kw = {k.arg: eval(compile(ast.Expression(k.value), "perf.py",
                                      "eval"), ns) for k in node.keywords}
            out.append((node.args[0].value, node.args[1].value,
                        kw.get("cfg_transform"), kw.get("rules")))
    return out


def test_variants_are_the_references():
    theirs_all = _reference_variants()
    assert [(v.cell, v.name) for v in perf.VARIANTS] == \
        [(c, n) for c, n, _, _ in theirs_all]
    for mine, (_, _, transform, rules) in zip(perf.VARIANTS, theirs_all):
        arch = mine.cell.split("/")[0]
        got, want = get_config(arch), jget_config(arch)
        if mine.cfg_transform is not None:
            got = mine.cfg_transform(got)
        if transform is not None:
            want = transform(want)
        for f in ("mla_latent_tp", "kv_block_tokens"):
            assert getattr(got, f) == getattr(want, f), (mine.name, f)
        for part in ("ssm", "moe"):
            if getattr(want, part) is not None:
                assert dataclasses.asdict(getattr(got, part)) == \
                    dataclasses.asdict(getattr(want, part)), mine.name
        assert rules is None
        assert mine.hypothesis and "GB" not in mine.hypothesis


def _cut(cells):
    return [v for v in perf.VARIANTS if v.cell.split("/")[0] in cells]


def _reduced(v):
    """``v`` on the reduced config: ``reduced()`` before its transform."""
    t = v.cfg_transform
    return dataclasses.replace(v, cfg_transform=lambda c: (
        c.reduced() if t is None else t(c.reduced())))


@pytest.fixture
def small_shapes(monkeypatch):
    """The cells' shapes cut to ``SMALL`` for the test."""
    for name, shape in SMALL.items():
        monkeypatch.setitem(dryrun.SHAPES, name, shape)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "qwen3_moe_30b_a3b",
                                  "deepseek_v2_lite_16b"])
def test_run_variant_gives_ok_rows_for_a_reduced_cell(arch, tmp_path,
                                                      small_shapes):
    out = tmp_path / "perf_report.jsonl"
    mesh = placeholder_mesh((2, 2))
    rows = {}
    for v in _cut([arch]):
        row = perf.run_variant(_reduced(v), str(out), mesh=mesh)
        assert row["status"] == "ok", (v.name, row.get("error"))
        assert row["cell"] == v.cell and row["variant"] == v.name
        assert row["hypothesis"] == v.hypothesis
        assert row["mesh"] == "2x2" and row["t_memory_s"] > 0
        assert "frac=" in perf.summary(row)
        rows[v.name] = row
    written = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["variant"] for r in written] == list(rows)
    if arch == "qwen3_moe_30b_a3b":
        same = {k: v for k, v in rows["baseline"].items()
                if k not in _RUN_KEYS}
        for name in ("attn_pinned", "attn_pinned_xsys", "qpin_bf16_final"):
            assert {k: v for k, v in rows[name].items()
                    if k not in _RUN_KEYS} == same, name
        assert rows["moe_ep"]["comm_calls"].get("all_to_all", 0) > 0
    if arch == "deepseek_v2_lite_16b":
        assert rows["baseline"]["kernels"] == {"paged_attention": 4}
        for name in ("latent_tp", "latent_tp_bt128"):
            assert rows[name]["kernels"] == {"paged_latent_scores": 4,
                                             "paged_latent_values": 4}
            assert rows[name]["comm_calls"]["all_reduce"] > 0
    # resumable: every (cell, variant) has its ok row, so main traces none
    assert perf.done_rows(str(out)) == {(v.cell, v.name) for v in _cut([arch])}
    assert perf.main(["--cell", arch, "--out", str(out)]) == []
    assert len(out.read_text().splitlines()) == len(rows)


def test_run_variant_writes_a_fail_row(tmp_path, small_shapes):
    out = tmp_path / "p.jsonl"
    bad = perf.Variant("deepseek_v2_lite_16b/decode_32k", "bad", "h",
                       cfg_transform=lambda c: dataclasses.replace(
                           c.reduced(), attention="none"))
    row = perf.run_variant(bad, str(out), mesh=placeholder_mesh((2, 2)))
    assert row["status"] == "FAIL" and row["error"]
    assert perf.done_rows(str(out)) == set()


def test_build_cell_train_step_remats_with_default_rules(monkeypatch,
                                                        small_shapes):
    """The train cell's step is the reference dry run's: remat, ZeRO-1
    and the default rules; a serve cell's step takes the default rules
    too."""
    calls = {}

    def spy(name):
        real = getattr(STEPS, name)

        def f(model, *a, **kw):
            calls[name] = kw
            return real(model, *a, **kw)
        return f

    for name in ("build_train_step", "build_serve_step"):
        monkeypatch.setattr(STEPS, name, spy(name))
    mesh = placeholder_mesh((2, 2))
    for shape in ("train_4k", "decode_32k"):
        dryrun.build_cell("gemma_2b", shape, mesh,
                          cfg_transform=lambda c: c.reduced())
    assert calls["build_train_step"] == {"mesh": mesh, "remat": True,
                                         "zero1": True}
    assert set(calls["build_serve_step"]) == {"mesh", "state_example"}


@pytest.mark.parametrize("variant,widths", [("baseline", (576,)),
                                            ("latent_tp", (32, 64))])
def test_full_width_deepseek_pools_on_the_production_mesh(variant, widths):
    v = next(v for v in perf.VARIANTS
             if v.cell == "deepseek_v2_lite_16b/decode_32k"
             and v.name == variant)
    mesh = placeholder_mesh((16, 16))
    _, args, _, chips = dryrun.build_cell(
        "deepseek_v2_lite_16b", "decode_32k", mesh,
        cfg_transform=v.cfg_transform)
    state = args[2]
    cfg = get_config("deepseek_v2_lite_16b")
    # B 128 over 16 data ranks: 8 rows of 512 blocks of 64 tokens
    lead = (cfg.num_layers, 8 * 512, 64)
    pools = [state.k_pool] + ([] if state.v_pool is None else [state.v_pool])
    assert [tuple(p.shape) for p in pools] == [lead + (w,) for w in widths]
    assert chips == 256 and all(p.device.type == "meta" for p in pools)
    attn = args[0]["layers"]["attn"]
    if variant == "latent_tp":
        # every head on every rank, wk_b / wv_b on their lora rows
        assert attn["wq"].shape[-1] == cfg.num_heads * 192
        assert attn["wk_b"].shape[1:] == (32, cfg.num_heads * 128)


def _rank_bytes(tree):
    if isinstance(tree, dict):
        return sum(_rank_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def test_full_width_deepseek_peak_counts_the_rank_pieces(tmp_path):
    """The rows' ``peak_mem_gb_per_chip`` differ by rank 0's input bytes:
    the pools' 576 -> 96 lanes a token save 6.79 GB, the replicated
    query projections and ``wo`` add 0.53 GB of pieces; what else the
    two steps keep alive (the scores' buffers, the new rows) stays
    within 0.1 GB.  A rank holding its parameters as views of the whole
    weights would count each whole storage in both rows, and their
    difference would read the pools' bytes alone."""
    mesh = placeholder_mesh((16, 16))
    rows, inputs = {}, {}
    for v in perf.VARIANTS:
        if v.cell != "deepseek_v2_lite_16b/decode_32k" or \
                v.name == "latent_tp_bt128":
            continue
        _, (params, _, state), _, _ = dryrun.build_cell(
            "deepseek_v2_lite_16b", "decode_32k", mesh,
            cfg_transform=v.cfg_transform)
        pools = state.k_pool.numel() * 2 + (
            0 if state.v_pool is None else state.v_pool.numel() * 2)
        inputs[v.name] = (_rank_bytes(params), pools)
        rows[v.name] = perf.run_variant(v, str(tmp_path / "p.jsonl"),
                                        mesh=mesh)
    (pb, sb), (pl, sl) = inputs["baseline"], inputs["latent_tp"]
    assert sb - sl == pytest.approx(6.795e9, rel=1e-3)
    assert pl - pb == pytest.approx(0.531e9, rel=1e-2)
    fall = (rows["baseline"]["peak_mem_gb_per_chip"]
            - rows["latent_tp"]["peak_mem_gb_per_chip"]) * 1e9
    assert abs(fall - ((sb - sl) - (pl - pb))) < 0.1e9
    assert rows["baseline"]["peak_mem_gb_per_chip"] * 1e9 < 1.1 * (pb + sb)
