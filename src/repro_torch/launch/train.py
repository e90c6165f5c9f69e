"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of ``python -m repro.launch.train`` on one device, with its
flags and defaults: builds the model with seeded random weights on
``--device`` (CUDA by default; ``--device cpu`` runs on the host), the
AdamW schedule (warmup 10 steps, cosine over ``--steps``), the train
step (``remat=True``) and the fault-tolerant loop over the synthetic or
memmap data, resuming from ``--ckpt-dir`` when it holds a checkpoint.
``--reduced`` makes every arch small.  Prints ``final loss: ...``.

Data parallelism: under ``torchrun --nproc_per_node N -m
repro_torch.launch.train ...`` every process is one rank of an (N, 1)
mesh (``Mesh.from_env``: nccl on the cards, gloo with ``--device cpu``);
the batch splits over the ranks, rank 0's parameters reach every rank by
broadcast, and ``--zero1`` splits the moments over the data axis.  A
process not launched by torchrun is a world of one, where ``--zero1``
runs the same step over one rank.  ``--model-parallel`` other than 1
raises: training over the model axis waits for its queue item (the
model axis serves only, ``launch/steps.py``).
``whisper_tiny`` and ``internvl2_1b`` raise too, before any
weight is made: their losses need ``frames`` or ``image_embeds``, which no
data source makes (the reference's launcher fails at its first step).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import CONFIG_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (MODEL_AXIS_TRAIN, broadcast_params,
                                      build_train_step, init_opt_state)
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
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: {MODEL_AXIS_TRAIN}")

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
    mesh = Mesh.from_env(device=args.device)
    if mesh.size == 1 and not args.zero1:
        step = build_train_step(model, opt_cfg, device=args.device)
        params = model.init(args.seed, device=step.device)
        opt_state = OPT.init_state(params)
    else:
        print(mesh.describe())
        step = build_train_step(model, opt_cfg, mesh=mesh, zero1=args.zero1)
        params = broadcast_params(mesh, model.init(args.seed,
                                                   device=mesh.device))
        opt_state = init_opt_state(mesh, params, step.in_shardings[1])

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed,
                          source=args.data, path=args.data_path)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir)
    out = run(step, params, opt_state, data_cfg, loop_cfg,
              device=step.device)
    if mesh.rank:
        return out
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f}, "
          f"stragglers: {out['stragglers']})")
    return out


if __name__ == "__main__":
    main()
