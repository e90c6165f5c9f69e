"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of ``python -m repro.launch.train`` on one device, with its
flags and defaults: builds the model with seeded random weights on
``--device`` (CUDA by default; ``--device cpu`` runs on the host), the
AdamW schedule (warmup 10 steps, cosine over ``--steps``), the train
step (``remat=True``) and the fault-tolerant loop over the synthetic or
memmap data, resuming from ``--ckpt-dir`` when it holds a checkpoint.
``--reduced`` makes every arch small.  Prints ``final loss: ...``.  On
one card the step is captured into one CUDA graph and replayed
(``train/step_graph.py``), and the launcher prints its captures and
replays; ``--eager-step`` runs it eagerly, as the CPU always does.

The mesh: under ``torchrun --nproc_per_node N -m
repro_torch.launch.train ...`` every process is one rank of a (N / M, M)
mesh, M = ``--model-parallel`` (1 by default), as the reference's
``make_host_mesh(model=M)`` (``Mesh.from_env``: nccl on one card a rank
with ``--device cuda``; gloo with ``--device cpu``, and with a card
named by its index, ``--device cuda:0``, which the processes share); an
M that does not divide N raises.  The batch splits over the data axis;
over the model axis each rank holds its pieces of the weights
(``launch.steps.shard_params``) and runs Megatron tensor parallelism
with sequence parallelism (``launch/steps.py``); the first data rank's
pieces reach its data peers by broadcast, and ``--zero1`` splits the
moments over the data axis.  A process not launched by torchrun is a
world of one, where ``--zero1`` runs the same step over one rank.  Every
rank logs nothing but rank 0, which prints each ``--log-every`` steps
(the loss, the clip norm, the step's wall time) and, on a mesh, each
rank's collectives and staged bytes a step and its peak device memory.
``--ckpt-every 0`` writes no checkpoint.  ``whisper_tiny`` and
``internvl2_1b`` raise before any weight is made: their losses need
``frames`` or ``image_embeds``, which no data source makes (the
reference's launcher fails at its first step).
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs.base import CONFIG_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (broadcast_params, build_train_step,
                                      init_opt_state, shard_params)
from repro_torch.models.api import build_model
from repro_torch.optim import adamw as OPT
from repro_torch.train.loop import TrainLoopConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=CONFIG_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eager-step", action="store_true",
                    help="run the one-device train step eagerly instead "
                         "of replaying its captured CUDA graph")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    tp = args.model_parallel
    if tp < 1 or world % tp:
        raise ValueError(f"--model-parallel {tp} does not divide the "
                         f"world of {world} process(es)")

    cfg = get_config(args.arch)
    if cfg.encoder is not None or cfg.num_image_tokens:
        raise NotImplementedError(
            f"--arch {args.arch}: its loss takes "
            f"{'frames' if cfg.encoder is not None else 'image_embeds'}, "
            f"which no data source makes (--data {args.data} yields tokens "
            f"and targets only)")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt_cfg = OPT.AdamWConfig(lr_peak=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    mesh = Mesh.from_env((world // tp, tp), device=args.device)
    if mesh.size == 1 and not args.zero1:
        step = build_train_step(model, opt_cfg, device=args.device,
                                graph=False if args.eager_step else None)
        params = model.init(args.seed, device=step.device)
        opt_state = OPT.init_state(params)
    else:
        print(mesh.describe())
        step = build_train_step(model, opt_cfg, mesh=mesh, zero1=args.zero1)
        pshard, oshard = step.in_shardings
        params = shard_params(mesh, model.init(args.seed, device=mesh.device),
                              pshard, copy=True)
        params = broadcast_params(mesh, params)
        opt_state = init_opt_state(mesh, params, oshard)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed,
                          source=args.data, path=args.data_path)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir,
                               log_every=args.log_every)
    mesh.stats.reset()
    if step.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(step.device)
    out = run(step, params, opt_state, data_cfg, loop_cfg,
              device=step.device)
    if mesh.size > 1:
        _report(mesh, step.device, len(out["losses"]))
    if mesh.rank:
        return out
    if step.graphs is not None and step.graphs.graph:
        st = step.stats()
        print(f"train step: {st['captures']} capture(s), {st['replays']} "
              f"replays, {st['eager_steps']} eager steps, graph pool "
              f"{st['pool_bytes'] / 2**20:.1f} MiB")
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f}, "
          f"stragglers: {out['stragglers']})")
    return out


def _report(mesh: Mesh, device: torch.device, steps: int) -> None:
    """Each rank's collectives, staged bytes and host seconds in them a
    step (the loop's, checkpoints included) and peak device memory,
    printed by rank 0."""
    st = mesh.stats
    calls = dict(st.calls)
    per = max(1, steps)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    line = torch.tensor([float(sum(st.calls.values())) / per,
                         float(sum(st.bytes.values())) / per,
                         float(st.staged_bytes) / per,
                         float(sum(st.seconds.values())) / per, float(peak)],
                        dtype=torch.float64, device=mesh.device)
    rows = mesh.all_gather(line, mesh.axis_names).cpu()
    if mesh.rank:
        return
    for r, (calls, nbytes, staged, secs, pk) in enumerate(rows.tolist()):
        print(f"rank {r}: {calls:.1f} collectives a step, {nbytes:.0f} B "
              f"handed in, {staged:.0f} B staged through pinned host "
              f"memory, {secs:.3f} s in them; peak device memory "
              f"{pk / 2**30:.2f} GiB")
    print(f"rank 0's collectives over {steps} steps: {calls}")


if __name__ == "__main__":
    main()
