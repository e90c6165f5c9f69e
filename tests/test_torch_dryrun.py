"""The dry run (``repro_torch.launch.dryrun``) and its report tables.

* ``run_cell`` on a small placeholder mesh gives an ``ok`` row for a
  reduced dense, MoE, MLA and state-family cell of each kind (train,
  prefill, decode), the row under the reference's keys; the account's
  collectives are rank 0's ``CommStats`` of the same step.
* Full-width ``gemma_2b x decode_32k`` on the 16 x 16 placeholder
  production mesh gives an ``ok`` row in seconds, with #1 launched once a
  layer and no card touched.
* ``mamba2_370m x decode_32k`` gives a ``FAIL`` row naming the serve
  step's ``TypeError``, the reference's own refusal of a Mamba2 state on
  a mesh.
* ``main`` writes resumable JSONL and exits 1 on a ``FAIL``; the port's
  ``report.fmt_table`` and ``fmt_dryrun_table`` render the rows to the
  reference's strings, and ``report.main`` renders the file.
"""

import dataclasses
import json

import pytest
import torch

from repro import report as jreport
from repro import roofline as jroofline
from repro_torch import report, roofline
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import placeholder_mesh

torch.set_num_threads(1)

SMALL = {"train_4k": InputShape("train_4k", 32, 4, "train"),
         "prefill_32k": InputShape("prefill_32k", 64, 2, "train"),
         "decode_32k": InputShape("decode_32k", 64, 4, "decode")}
REDUCED = ["gemma_2b", "qwen3_moe_30b_a3b", "minicpm3_4b", "rwkv6_7b",
           "zamba2_2p7b"]


def _reduced_row(arch, shape_name, mesh_shape=(2, 2)):
    mesh = placeholder_mesh(mesh_shape)
    row = dryrun.run_cell(arch, shape_name, mesh=mesh, verbose=False,
                          cfg_transform=lambda c: c.reduced(),
                          shape=SMALL[shape_name])
    return row


@pytest.mark.parametrize("shape_name", list(SMALL))
@pytest.mark.parametrize("arch", REDUCED)
def test_reduced_cell_gives_an_ok_row(arch, shape_name):
    row = _reduced_row(arch, shape_name)
    assert row["status"] == "ok", row.get("error")
    want = set(jroofline.Roofline(
        arch=arch, shape=shape_name, mesh="m", chips=1, flops_per_chip=1.0,
        bytes_per_chip=1.0, coll_bytes_per_chip=0.0,
        peak_memory_per_chip=1.0, model_flops=1.0).row())
    assert want <= set(row)
    assert row["chips"] == 4 and row["mesh"] == "2x2"
    assert row["hlo_gflops_per_chip"] > 0 and row["hbm_gb_per_chip"] > 0
    assert row["peak_mem_gb_per_chip"] > 0
    assert row["t_collective_s"] > 0 and row["coll_gb_per_chip"] > 0
    assert row["xla_raw"]["flops"] > 0
    assert sum(row["comm_calls"].values()) > 0
    if shape_name == "train_4k":
        assert row["kernels"].get("adamw_update", 0) > 0


def test_full_width_gemma_decode_on_the_production_mesh():
    """The 16 x 16 cell as rank 0 sees it: B 128 over 16 data ranks, a
    32768-token context, the heads over 16 model ranks; one #1 launch a
    layer, and no CUDA call."""
    row = dryrun.run_cell("gemma_2b", "decode_32k", verbose=False)
    assert row["status"] == "ok", row.get("error")
    assert row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["kernels"] == {"paged_attention_append": 18}
    assert row["dominant_mem_op"] == "gather"
    assert row["bottleneck"] == "memory"
    assert not torch.cuda.is_initialized()


def test_mamba2_serve_cell_fails_as_the_reference_refuses():
    row = dryrun.run_cell("mamba2_370m", "decode_32k", verbose=False)
    assert row["status"] == "FAIL"
    assert row["error"].startswith("TypeError")
    assert "Mamba2State" in row["error"]


def test_skipped_cell_names_its_reason():
    row = dryrun.run_cell("gemma_2b", "long_500k", verbose=False)
    assert row["status"] == "skipped" and "N/A-by-spec" in row["reason"]


def test_collective_term_reads_link_rates():
    """A group inside one 8-card board goes at NVLink's rate, any other
    at the network's; bytes without a group at the network's."""
    kw = dict(arch="a", shape="s", mesh="m", chips=16, flops_per_chip=0.0,
              bytes_per_chip=0.0, coll_bytes_per_chip=9e9,
              peak_memory_per_chip=0.0, model_flops=1.0)
    rl = roofline.Roofline(**kw, coll_groups={
        ("all-reduce", ("model",), (0, 1, 2, 3)): 4.5e9,
        ("all-gather", ("data",), (0, 8)): 4.5e9})
    assert rl.t_collective == pytest.approx(4.5e9 / 450e9 + 4.5e9 / 50e9)
    assert rl.bottleneck == "collective"
    assert roofline.Roofline(**kw).t_collective == pytest.approx(9e9 / 50e9)


def _rows():
    ok = dict(_reduced_row("gemma_2b", "decode_32k"), mesh="16x16")
    fail = dryrun.run_cell("mamba2_370m", "decode_32k", verbose=False)
    fail.pop("trace")
    skip = dryrun.run_cell("gemma_2b", "long_500k", verbose=False)
    multi = dict(ok, mesh="pod2x16x16")
    return [ok, fail, skip, multi]


def test_report_tables_equal_the_reference_on_dryrun_rows():
    rows = _rows()
    for mesh in ("16x16", "pod2x16x16"):
        assert report.fmt_table(rows, mesh) == jreport.fmt_table(rows, mesh)
    assert report.fmt_dryrun_table(rows) == jreport.fmt_dryrun_table(rows)


def test_main_writes_resumable_rows_and_report_renders_them(tmp_path,
                                                             capsys):
    out = tmp_path / "dryrun_report.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k,long_500k",
                     "--out", str(out)])
    assert e.value.code == 0
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["ok", "skipped"]
    with pytest.raises(SystemExit) as e:        # resumed: nothing to do
        dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 0
    assert len(out.read_text().splitlines()) == 2
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2_370m", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 1
    capsys.readouterr()
    report.main(str(out))
    printed = capsys.readouterr().out
    jreport.main(str(out))
    assert printed == capsys.readouterr().out
    assert "| gemma_2b | decode_32k |" in printed


def test_specs_only_builds_the_cells(tmp_path):
    out = tmp_path / "specs.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3_moe_30b_a3b", "--shape",
                     "train_4k,decode_32k", "--specs-only",
                     "--out", str(out)])
    assert e.value.code == 0
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["lowered", "lowered"]


def test_shapes_are_the_reference_shapes():
    assert set(SMALL) < set(SHAPES)
    assert all(dataclasses.replace(SHAPES[k], seq_len=v.seq_len,
                                   global_batch=v.global_batch) == v
               for k, v in SMALL.items())


@pytest.mark.parametrize("shape,want", [((16, 16), "16x16"),
                                        ((2, 16, 16), "pod2x16x16"),
                                        ((2, 2), "2x2")])
def test_row_mesh_is_the_mesh_shape(shape, want):
    assert dryrun.mesh_desc(placeholder_mesh(shape)) == want
