"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

``--arch`` is any id of ``configs.base.CONFIG_IDS``: the decoders, the
SSMs ``mamba2_370m`` and ``rwkv6_7b`` (constant-state pool) and the
``zamba2_2p7b`` hybrid (paged KV + constant state) are served;
``whisper_tiny`` and ``internvl2_1b`` are refused by the engine's
``build_strategy`` (whisper's row is registered but unserved, as in the
reference; the engine hands a model no image embeddings).  Builds the model
with seeded random weights on ``--device`` (CUDA by default), a seeded
arrival trace (``serve.traffic.make_trace``), feeds it to
``Engine.serve`` and reports throughput, the per-step phase split, pool
utilization, swap traffic, prefix sharing and per-tenant latency.
``--device cpu`` runs the plain PyTorch versions of the kernels.  The
resident decode tail replays one captured CUDA graph per update width,
and a paged strategy's prefill and suffix prefill one captured CUDA
graph per ``(B, S)`` bucket from the bucket's second sighting on;
``--eager-graphs`` runs both eagerly instead.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import CONFIG_IDS, get_config
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import FairAdmission
from repro_torch.serve.traffic import TRACE_KINDS, make_trace


def _budget(v: str):
    """``--prefill-budget``: a positive int, 'auto', or 'none'."""
    if v == "auto":
        return "auto"
    if v in ("none", "None"):
        return None
    return int(v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=CONFIG_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--trace", choices=TRACE_KINDS, default="poisson")
    ap.add_argument("--mean-gap", type=float, default=2.0)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--prompt-cap", type=int, default=32)
    ap.add_argument("--policy", choices=("fcfs", "fair"), default="fcfs")
    ap.add_argument("--watermark", type=int, default=None)
    ap.add_argument("--prefill-budget", type=_budget, default="auto")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--eager-graphs", action="store_true",
                    help="run the resident decode tail and the paged "
                         "prefill buckets eagerly instead of replaying "
                         "captured CUDA graphs")
    ap.add_argument("--shared-frac", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    eng = Engine(model, params, slots=args.slots, max_seq=args.max_seq,
                 num_blocks=args.num_blocks, eos_id=-1,
                 watermark=args.watermark,
                 prefill_budget=args.prefill_budget,
                 admission_policy=(FairAdmission() if args.policy == "fair"
                                   else None),
                 overlap_transfers=not args.no_overlap,
                 graphs=not args.eager_graphs, device=args.device)
    source = make_trace(args.trace, args.requests, cfg.vocab_size,
                        seed=args.seed, mean_gap=args.mean_gap,
                        tenants=args.tenants, max_new=args.max_new,
                        prompt_cap=args.prompt_cap,
                        shared_frac=args.shared_frac)
    t0 = time.perf_counter()
    done = eng.serve(source, max_steps=100_000)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.stats
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)}/{args.requests} requests on {eng.device}: "
          f"{toks} tokens in {dt:.3f}s ({toks / max(dt, 1e-9):.1f} tok/s), "
          f"{eng.steps} engine steps, final pool util "
          f"{eng.mgr.utilization:.0%}")
    print("phase split (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
    print(f"prefix-share hits {st['prefix_hits']}, prefill tokens saved "
          f"{st['prefill_tokens_saved']}, COW copies {st['cow_copies']}, "
          f"preemptions {st['preemptions']}, swap out/in "
          f"{st['swap_out_bytes']}/{st['swap_in_bytes']} bytes, "
          f"compactions {st['compactions']}")
    pg = st["prefill_graphs"]
    if pg.get("graphs"):
        print("prefill graphs (bucket: seen/captured/replayed): " + ", ".join(
            f"{k}: {b['sightings']}/{b['captures']}/{b['replays']}"
            for k, b in pg["buckets"].items())
            + f"; {pg['recaptures']} recaptures, capture "
              f"{pg['capture_s']:.3f} s")
    for tenant, row in eng.latency_report().items():
        def fmt(v):
            return "n/a" if v is None else f"{v:.1f}"
        print(f"  {tenant}: {row['requests']} requests, TTFT p50/p99 "
              f"{fmt(row['ttft_p50_ms'])}/{fmt(row['ttft_p99_ms'])} ms, "
              f"ITL p50/p99 {fmt(row['itl_p50_ms'])}/"
              f"{fmt(row['itl_p99_ms'])} ms")
    return done


if __name__ == "__main__":
    main()
