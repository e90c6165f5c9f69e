"""Dry run: trace every (arch x shape) cell as rank 0 of the production
mesh, on placeholder ranks and meta tensors, and write its roofline row.

    python -m repro_torch.launch.dryrun --mesh single
    python -m repro_torch.report dryrun_report.jsonl

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell on 512 forced host devices and reads the
optimised HLO.  This package compiles nothing ahead of time, so a cell
is traced instead: its step runs once, as rank 0 of the (16, 16)
or (2, 16, 16) mesh (``launch.mesh.placeholder_mesh``: no process
groups, collectives that talk to nobody) on meta tensors -- the rank's
pieces of the parameters, optimizer state, batch and decode state --
under the cost recorder (``repro_torch.cost``), which bills every op,
kernel launch and collective of that rank's program and tracks its peak
of live bytes.  No card is needed, and none is touched.

For each runnable cell (``configs/shapes.py``), as the reference chooses:
  * ``train_4k``     -> the train step, ZeRO-1, remat;
  * ``prefill_32k``  -> the forward step (inference prefill);
  * ``decode_32k`` / ``long_500k`` -> the serve step at ``dp_groups_for``.

A row is the reference's (``roofline.Roofline.row``: terms at the H100's
datasheet rates, an account and not a measurement); the tracing seconds
go where the reference writes ``t_compile_s``.  A step the port refuses
gives a ``FAIL`` row naming the refusal; the output is resumable and the
script exits 1 on any ``FAIL``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

from repro_torch import cost as COST
from repro_torch import roofline as RL
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, InputShape, cell_is_runnable
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.api import build_model, decode_specs, input_specs
from repro_torch.optim import adamw as OPT


def build_cell(arch: str, shape_name: str, mesh: Mesh, *,
               cfg_transform: Optional[Callable] = None,
               shape: Optional[InputShape] = None
               ) -> Tuple[Callable, tuple, float, int]:
    """``(step, args, model_flops, chips)``: a cell's step on ``mesh`` and
    this rank's meta inputs to it (built here, outside any recording).
    ``cfg_transform`` and ``shape`` (in place of ``SHAPES[shape_name]``,
    whose kind it must share) cut a cell down, as the tests do."""
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape_name] if shape is None else shape
    model = build_model(cfg, max_positions=max(
        4096, shape.seq_len if shape.kind == "train" else 4096))
    pshapes, _ = model.param_specs()
    if shape.kind == "train":
        batch = STEPS.shard_batch(mesh, input_specs(cfg, shape))
        if shape_name.startswith("prefill"):
            step = STEPS.build_forward_step(model, mesh=mesh, remat=False)
            params = STEPS.shard_params(mesh, pshapes, step.in_shardings)
            args = (params, batch)
        else:
            # ZeRO-1, as the reference's dry run: replicated AdamW moments
            # would not fit a rank at 27B
            step = STEPS.build_train_step(model, OPT.AdamWConfig(),
                                          mesh=mesh, remat=True, zero1=True)
            pshard, oshard = step.in_shardings
            params = STEPS.shard_params(mesh, pshapes, pshard, copy=True)
            args = (params, STEPS.init_opt_state(mesh, params, oshard),
                    batch)
    else:
        dp = STEPS.dp_groups_for(mesh, shape.global_batch)
        tokens, state = decode_specs(cfg, shape, model=model, dp_groups=dp)
        step = STEPS.build_serve_step(model, mesh=mesh, state_example=state)
        params = STEPS.shard_params(mesh, pshapes, step.in_shardings)
        tokens = STEPS.shard_batch(mesh, {"tokens": tokens})["tokens"]
        args = (params, tokens, STEPS.shard_state(mesh, state, cfg))
    return step, args, RL.model_flops_for(cfg, shape), mesh.size


def trace_cell(arch: str, shape_name: str, mesh: Mesh, **kw):
    """``(cost, peak, raw, model_flops, chips)`` of one cell: its step
    run once on this rank's meta inputs under the cost recorder (and
    ``FlopCounterMode`` for ``raw``)."""
    step, args, model_flops, chips = build_cell(arch, shape_name, mesh, **kw)
    with COST.counter.flop_counter() as fc:
        cost, peak = COST.analyze(step, *args)
    return cost, peak, COST.counter.raw(fc), model_flops, chips


def mesh_desc(mesh: Mesh) -> str:
    """The row's ``mesh``, from the mesh's own shape: ``16x16``,
    ``pod2x16x16``, or ``2x2`` for a small test mesh."""
    return (("pod" if "pod" in mesh.shape else "")
            + "x".join(str(n) for n in mesh.shape.values()))


def _production(multi_pod: bool) -> Mesh:
    return make_production_mesh(multi_pod=multi_pod, placeholder=True)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             mesh: Optional[Mesh] = None, verbose: bool = True,
             **trace_kw) -> Dict:
    """One cell's row: ``ok`` with its roofline terms, ``skipped`` where
    ``cell_is_runnable`` says so, or ``FAIL`` naming the exception.
    ``mesh`` defaults to rank 0 of the placeholder production mesh;
    ``trace_kw`` go to ``build_cell``."""
    if mesh is None:
        mesh = _production(multi_pod)
    desc = mesh_desc(mesh)
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": desc,
                "status": "skipped", "reason": why}
    t0 = time.time()
    try:
        cost, peak, raw, model_flops, chips = trace_cell(
            arch, shape_name, mesh, **trace_kw)
        t_trace = time.time() - t0
        rl = RL.analyze(cost, peak, arch=arch, shape=shape_name,
                        mesh_desc=desc, chips=chips, model_flops=model_flops,
                        raw=raw)
        row = rl.row()
        row.update(status="ok", t_lower_s=0.0,
                   t_compile_s=round(t_trace, 1),
                   comm_calls=dict(mesh.stats.calls),
                   kernels={k: v["launches"] for k, v in cost.kernels.items()})
        if verbose:
            print(f"  account: {cost.bytes / 1e9:.2f} GB moved, "
                  f"{cost.flops / 1e9:.1f} GFLOP, peak {peak / 1e9:.2f} GB, "
                  f"{sum(mesh.stats.calls.values())} collectives", flush=True)
        return row
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": desc,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    finally:
        mesh.stats.reset()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="dryrun_report.jsonl")
    ap.add_argument("--specs-only", action="store_true",
                    help="build each cell's meta inputs and step, trace "
                         "nothing (status 'lowered')")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    done = set()
    if os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") in ("ok", "skipped", "lowered"):
                done.add((r["arch"], r["shape"], r["mesh"]))

    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    key = (arch, shape, mesh_desc(_production(mp)))
                    if key in done:
                        continue
                    desc = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                    print(f"[dryrun] {desc} ...", flush=True)
                    if args.specs_only:
                        row = _specs_row(arch, shape, mp)
                    else:
                        row = run_cell(arch, shape, mp)
                    status = row["status"]
                    if status == "ok":
                        print(f"  OK  bottleneck={row['bottleneck']} "
                              f"t=({row['t_compute_s']:.4f}, "
                              f"{row['t_memory_s']:.4f}, "
                              f"{row['t_collective_s']:.4f})s "
                              f"frac={row['roofline_fraction']:.3f}",
                              flush=True)
                    elif status == "FAIL":
                        n_fail += 1
                        print(f"  FAIL {row['error']}", flush=True)
                    else:
                        print(f"  {status}: {row.get('reason', '')}",
                              flush=True)
                    row.pop("trace", None)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
    sys.exit(1 if n_fail else 0)


def _specs_row(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """``--specs-only``: a cell's step and meta inputs built, nothing
    run (the reference's ``--lower-only``)."""
    mesh = _production(multi_pod)
    desc = mesh_desc(mesh)
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": desc,
                "status": "skipped", "reason": why}
    t0 = time.time()
    try:
        build_cell(arch, shape_name, mesh)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": desc,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
    return {"arch": arch, "shape": shape_name, "mesh": desc,
            "status": "lowered", "t_lower_s": round(time.time() - t0, 1)}


if __name__ == "__main__":
    main()
