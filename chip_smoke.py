#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports only ``repro_torch`` (from ``src/``), torch and numpy.  Phases,
each fatal on failure:

1. build the ``sm_90a`` kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit;
2. hold every ported kernel against its plain PyTorch version on the
   card at small float32 and bfloat16 shapes and at the edges (length 0,
   full table, NULL table entries, softcap and window, fully masked
   rows), ``paged_attention`` also at G <= 16 and at MLA's G = 40 in
   latent mode, and the three tree kernels at leaves whose byte size is
   not a multiple of 16, on unaligned pools, with one leaf, repeated
   ids, no id (no launch), one row per block and a block's first and
   last rows; the split-key ``paged_attention_append`` and the tiled
   ``paged_prefill_attention`` also at gemma-2b's, gemma2-27b's,
   Qwen3-30B-A3B's, gemma3-27b's and InternVL2-1B's widths (G 7, whose
   16-row tiles straddle query positions) and the append at Zamba2's
   and Whisper-tiny's (G 1, HD 80 and 64), over 6-, 7-, 8-, 24- and
   64-block tables (many splits, some empty), lengths at every block and table
   edge and around gemma3's 1024-token window, NULL entries, windows
   inside and on block edges, and suffixes with rows past ``kv_len``,
   fully masked rows and rows across the window's edge; the split-key
   ``paged_attention`` likewise at G 1, 4, 40 (MiniCPM3-4B's latent
   mode) and 16 (DeepSeek-V2-Lite's 576-wide latent, V 512), with
   lengths at every split edge, a window starting on a split's edge,
   the self term and float32 output; the block kernel
   (#3-#6, all four wrappers, numpy ids) bitwise, at the parameter
   block's cap - 1, cap and
   cap + 1 ids (the last uploaded from pinned memory, also run under
   ``set_sync_debug_mode("error")``), 42-, 84- and 320-byte blocks, 1
   and 62 layers of 32 KB and 36,864-byte blocks, and pool views whose
   base is not 16-byte aligned;
3. serve full-width gemma-2b (18 layers, d=2048, 8 query heads / 1 KV
   head, head_dim 256, d_ff 16384, vocab 256000, bfloat16, 64-token
   blocks; ~5 GB of weights from a seeded ``torch.Generator``) through
   ``Engine.serve`` over a seeded ``prefixheavy`` trace with a pool small
   enough to force preemption, ``SERVE_RUNS`` times on fresh engines,
   with every kernel launch counter zeroed just before each run and
   read just after: each run must show COW forks, suffix prefill,
   swap-out and swap-in, a compaction and launches of every kernel on
   the path, and end with a quiescent Arena.  A first, untimed run
   records the kernels' arguments and warms every shape; tokens/s comes
   from the uninstrumented runs after it;
4. at the heaviest call the recorded run gave each kernel (for decode,
   the step with the most live rows and cached keys), compare the
   kernel with its plain version and time both, beside one PyTorch
   library call computing the same function where there is one, and the
   least time the card could take (bytes at 3.35 TB/s or operations at
   the bf16 tensor-core peak, whichever is larger); call the append and
   the prefill once each under ``torch.cuda.set_sync_debug_mode("error")``
   (a wrapper that synchronises with the host fails), and log the append
   at 4096 keys per row beside SDPA; replay the block kernels' recorded
   calls (#3 beside ``pool[:, d] = pool[:, s]`` with device int64 ids,
   two PyTorch ops), log each call's device time split into kernels and
   memory copies, call all four block wrappers with numpy ids under
   ``set_sync_debug_mode("error")``, and log large plans on a 128-block
   pool of gemma-2b's widths (gather and scatter of 64 blocks, a copy
   of 32), each equal to its plain version and timed beside
   ``index_select`` / ``index_copy_`` / the two-op copy and its bound,
   four pools in turn so that each timed call reads HBM, not the L2;
5. compare one full-width decode step's logits between the kernel path
   and the plain path, in bfloat16 and with the weights in float32, where
   the plain path with a planted fault (the new token left out) must
   fall outside the limit that the kernel path meets, and log how far
   each path's bfloat16 logits lie from the float32 step's; hold the
   ``reduced()`` float32 model's logits at
   every decode step to the plain path's, and serve a ``reduced()``
   engine on both paths, which must decode identical tokens;
6. the second path, absorbed MLA from a paged latent pool: serve
   full-width MiniCPM3-4B (62 layers, d=2560, 40 heads, q_lora 768,
   kv_lora 256, rope 32, nope 64, v 64, d_ff 6400, vocab 73448, bfloat16,
   64-token blocks of 288-wide latents; ~8.1 GB of weights from a seeded
   generator) through ``Engine.serve`` on the same engine settings and
   trace kind, with the launch counters zeroed just before each run and
   read just after: each run must show, from the trace alone, a prefix
   hit (0 prefill tokens saved: MLA recomputes a forked prompt), a COW
   copy, a preemption with swap-out and swap-in of whole latent blocks,
   ``paged_attention`` launched once per layer per decode step and the
   GQA attention kernels never; then time ``paged_attention`` at its
   heaviest recorded call beside SDPA and its plain version, call it once
   under ``set_sync_debug_mode("error")``, log it at 4096 keys per row
   beside SDPA, replay the block kernels' recorded calls on
   the 62-layer latent pools as in phase 4 (each equal to its plain
   version, all four under ``set_sync_debug_mode("error")``), the large
   plans' gather and scatter of 64 latent blocks, time ``block_copy`` on
   one layer of the latent pool beside ``pool[d] = pool[s]``, compare a
   full-width decode step between the kernel and plain paths as in phase
   5, log how far each path's bfloat16 logits lie from the float32
   step's over 4 decode setups (``F32_SEEDS``), and
   hold the ``reduced()`` float32 MLA model to the plain path (logits at
   every step, engine tokens);
7. the third path, the paper's data structures: run the paper's
   experiments (``repro_torch.bench.tree_scan``: Table 2's scans at 4 KB
   to 4 GB, ``repro_torch.bench.gups``: Fig. 4's GUPS at 4 MB to 4 GB,
   the pointer chase, and a paged lookup of 4096 rows of gemma-2b's
   1.05 GB embedding table) with the launch counters zeroed just before
   and read just after: ``tree_gather``, ``tree_block_sum`` and
   ``tree_gather_rows`` must each launch, ``tree_gather`` once per
   ``TreeArray.to_dense`` call, and no other kernel.  At every size the
   tree holds the dense array bitwise, its GUPS result is the dense
   one's within ``gups.GUPS_TOL`` and ``scan_sum_iter`` is within
   ``tree_scan.SUM_TOL`` of sum|x| of the float64 sum.  Then at a 4 GB
   tree (131,072 leaves of 8192 float32, depth 4) time ``tree_gather``
   and ``tree_block_sum``, and at the embedding lookup
   ``tree_gather_rows``, each against its plain version, its bound and
   ``index_select`` (#8) or the dense baseline (#9 per-leaf sums of the
   contiguous array, #10 ``embedding``); print each tree/dense ratio;
8. the MoE decoders, each served at full width and depth through
   ``Engine.serve`` on phase 3's engine settings over a ``prefixheavy``
   trace whose seed shows a COW copy and a preemption with swap-out and
   swap-in from the trace alone, one recorded run and ``MLA_RUNS`` timed
   runs with the launch counters zeroed before each and read after:
   Qwen3-30B-A3B (48 layers, d 2048, 32 heads over 4 KV heads, head_dim
   128 with qk-norm, 128 experts top-8 of d_ff 768, vocab 151936,
   untied, bfloat16: 61 GB of seeded weights), whose decode launches #1
   once per layer per step and whose forks take suffix prefill (#2);
   then #1 and #2 at their heaviest recorded calls and #1 at 4096 keys,
   a full-depth bfloat16 decode step between the kernel and plain paths
   (wall and device time, idle share; how many of its (layer, row)
   routings differ between the paths, and its gap with the kernel path
   routed as the plain path), the float32 step with its planted
   fault on the first ``F32_DEPTH`` layers at full width, the MoE
   feed-forward of a decode step timed beside its routed experts' byte
   bound and once under ``set_sync_debug_mode("error")``, and the
   ``reduced()`` float32 model against the plain path; each phase logs
   its peak device memory;
9. the same for DeepSeek-V2-Lite (27 layers, the first dense, d 2048, 16
   heads of MLA with full-rank q, kv_lora 512, rope 64, nope 128, v 128,
   64 experts top-6 of d_ff 1408 and 2 shared, vocab 102400, bfloat16:
   31 GB), served from the 576-wide latent pool: #7 once per layer per
   decode step, #1 and #2 never; #7 at its heaviest recorded call beside
   SDPA and its plain version, and at 4096 keys;
10. the constant-state paths, each at published widths in bfloat16 with
    weights from seed 0, on phase 3's engine settings and a
    ``prefixheavy`` trace, one recorded run and ``STATE_RUNS`` timed
    runs with the launch counters zeroed before each and read after:
    Mamba2-370M (48 SSD layers, d 1024, state 128, vocab 50288) from one
    12,914,688-float32 state block per sequence in a flat pool; no
    prefix is shared, a preemption is forced after ``FORCE_AT`` steps
    (12 state blocks never run out for 4 slots) and round-trips whole
    state blocks, and a compaction of the state pool launches #6, which
    is replayed bitwise against its plain version and timed beside
    ``pool[d] = pool[s]`` (the kernels line's #6 row); then one sequence
    preempted after 3 steps resumes to the uninterrupted run's tokens,
    one decode step's wall and device time and idle share, the engine's
    whole resident decode step under ``set_sync_debug_mode("error")``
    (rows re-spliced, then steady), the bfloat16 step's logits against
    the float32 step's over all layers (logged, no limit), and the
    ``reduced()`` float32 model on the card against the CPU (logits
    within 1e-4 over 12 decode steps, identical tokens, an engine each
    with identical tokens);
11. the same for the Zamba2-2.7B hybrid (54 Mamba2 layers, d 2560, a
    shared attention block every 6 of them: 32 heads, head_dim 80,
    LoRA 128; state and paged KV admitted, swapped and released
    together), whose trace preempts from the KV pool alone: #1 once per
    shared-attention invocation per decode step at its heaviest
    recorded call beside SDPA, #3-#5 replayed on its 9-layer KV pool,
    and the decode step between the kernel and plain paths in bfloat16
    and in float32 with the planted fault as in phase 5;
12. the same as phase 10 for RWKV6-7B (32 layers, d 4096, 64 heads of
    64, d_ff 14336, vocab 65536; 15 GB), its float32 step over all 32
    layers;
13. live migration, restart snapshot and disaggregation: full-width
    gemma-2b on phase 3's engine settings and trace, served ``MIGRATE_AT``
    steps with one ``preempt_latest()`` and moved by ``migrate_live`` to a
    fresh engine, must decode a control run's tokens for every request
    after 2+ pre-copy rounds, with a stop-and-copy tail of fewer blocks
    than the first round and #4/#5 launched during the move; the
    destination's blocks, read through the restored mappings, must equal
    a ``gather_device_payload`` of the source taken just before
    ``finalize`` bit for bit, and a restore of the snapshot with one byte
    flipped must fail that check; the pause is logged beside a
    stop-everything ``Arena.snapshot(include_device=True)`` of the same
    state.  Then the trace's first 4 requests through a ``PrefillWorker``
    and a ``DisaggregatedEngine`` (tokens equal to a monolithic engine's,
    4 handoffs of whole 1,179,648 B blocks, the worker's pool back to its
    sink, no recapture on the decode engine), Mamba2-370M migrated as
    gemma-2b on phase 10's settings (its tail: every running row's whole
    state block), and #4 and #5 at the phase's heaviest calls against
    their plain versions, bit for bit;
14. training, a path that runs no kernel of ``kernels/`` (the
    reference's reaches no ``pallas_call`` either): the reduced float32
    gemma_2b, qwen3_moe_30b_a3b and mamba2_370m on the card against the
    CPU (the loss and every gradient leaf within ``F32_TOL`` of the
    leaf's max, then the parameters after 3 AdamW steps); gemma-2b's
    published widths cut to ``TRAIN_CUT`` layers in float32 at B 1,
    S 64, card against CPU within ``F32_TOL``, with a planted fault (the
    -1 target mask ignored) outside it; full-width gemma-2b in bf16
    (2.506 B parameters, seed 0, ``remat=True``, B ``TRAIN_B``, S
    ``TRAIN_S``) trained by ``build_train_step``: ``TRAIN_WARM``
    untimed and ``TRAIN_TIMED`` timed steps on one batch with finite,
    falling losses and no kernel launched, the step's wall and device
    time, idle share, peak memory, the forward/backward and AdamW device
    times, the largest kernels, the bound (remat's 8 N T operations at
    the bf16 peak plus AdamW's 22 bytes a parameter at HBM's rate) and
    the MFU (6 N T over the step at the bf16 peak); reduced gemma_2b
    through ``train.loop.run`` in float32 (``SyntheticLM``) and bf16
    (``MemmapTokens``, its TreeArray index on the card), 8 steps against
    4 + resume to 8, bitwise; and the ``TRAIN_CUT``-layer cut's bf16
    parameters and float32 moments (7.44 GB) saved from the card and
    restored onto it bitwise, with the write's and the read's GB/s
    (files in a ``.phase14-*`` temporary directory of the checkout);
15. Whisper-tiny (4 + 4 layers, d 384, 6 heads of 64, d_ff 1536, vocab
    51865, 1500 frames; 41 M parameters) and InternVL2-1B (24 layers,
    d 896, 14 heads over 2 KV heads of 64, d_ff 4864, vocab 151655, 256
    image tokens; 0.49 B) at published widths in bf16, weights from
    seed 0, at model level as the reference holds them (neither is
    served by the engine): ``ENC_B`` rows of seeded inputs -- whisper's
    frames and prompts of up to 64 tokens, then 64 greedy decode steps
    (within its 448-token context); InternVL2's image embeddings and up
    to 128 text tokens, a one-block text suffix through
    ``prefill_suffix`` (#2), then 32 decode steps -- with the launch
    counters zeroed just before and read just after: #1 once per layer
    per step, #2 once per layer of the suffix; #1 (and #2) at the
    heaviest recorded call against the plain version, beside SDPA and
    its bound, and once under ``set_sync_debug_mode("error")``; encode,
    prefill, suffix and decode-step wall (median) and device time, idle
    share and the greedy loop's tokens/s; the kernel path against the
    plain path in bf16 (LOGIT_TOL) and, with the weights in float32 at
    full depth, the suffix and a decode step (F32_LOGIT_TOL, which the
    plain path with the new token left out must exceed); the reduced
    float32 models on the card against the CPU (logits within F32_TOL,
    identical greedy tokens); one bf16 ``build_train_step(remat=True)``
    each (whisper B 8, S 448; InternVL2 B 4, 256 image + 256 text
    tokens), finite and falling losses, no kernel launched, the step's
    wall and device time, idle share, peak memory and MFU;
16. the paper's serving benchmarks, run right after phase 5 on phase 3's
    weights: ``repro_torch.bench.end2end`` (Fig. 5) at full width
    (gemma-2b, bf16, B 8, ``max_seq`` 2048, a context of 1024 tokens)
    and in its reduced float32 row -- each layout (paged at 8-64-token
    blocks, contiguous: one block of ``max_seq`` per row) holding the
    same seeded K/V, its step replayed from a captured CUDA graph: wall
    (median of 10), device time and #1's device time per step, #1's
    bound, each over the contiguous step, the logits' gap to the
    contiguous step within the bench's gate and the planted fault's gap
    (a permuted table), which must trip the float32 gate; then
    ``repro_torch.bench.serve --smoke`` (reduced) and the full-width
    ``bench.serve`` over a ``prefixheavy`` trace on phase 3's engine
    settings in 8-token blocks (``SERVE_FULL_ARGV``), each ending with
    every gate holding (``all_ok``) and #1, #4 and #5 launched; their
    files go to a ``.phase16-*`` temporary directory in the checkout.
    Phase 2 holds #1 also at 256- and 2048-token blocks
    (``large_block_checks``).

On every served path (phases 3, 6 and 8-12) the recorded run takes the
eager decode tail (``decode_graphs=False``), the timed runs replay the
decode graphs (one captured CUDA graph per update width), and one more
timed run on the eager tail is the control: the first graph run must
give the recorded run's tokens for every request, preemptions, swap
bytes and table-sync rows and bytes after every step, saved prefill
tokens and kernel launches, and every graph run must capture each width
it reaches once, recapture nothing and replay every decode step; both
tokens/s medians are logged.  Then the engine's resident tail
(``strategy.decode_resident``) is timed in the steady state, replayed
and eager (wall, device time, idle share), beside one capture's wall
and device time and the graph pool's bytes.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the card's peaks (H100 SXM datasheet) and ``bound`` come from the port;
# outside a checkout this import fails, and the script exits non-zero
# before it prints anything
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline import (F32_FLOPS, HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                  PEAK_FLOPS as BF16_FLOPS, bound)
BF16_TOL = 2e-2                    # |k - p| <= tol + tol * |p|, one bf16
F32_TOL = 1e-4                     # rounding apart; float32: reordering
# full-width decode-step logits, |kernel - plain| / max|plain|.  In
# bfloat16 the rounding compounds over the layers: on an H100 the sound
# gap and the gap of a planted fault (the new token left out) read
# 1.0e-2 and 1.7e-2 for MiniCPM3-4B, and 5.5e-4 both for gemma-2b (one
# bf16 step of a logit), too close for a limit, so the bf16 limit only
# catches gross failures.  In float32 they read 4.4e-7 and 1.3e-2 (2.5e-8
# and 9.0e-5 for gemma-2b): the float32 step carries the tight limit,
# and each run re-reads the fault.
LOGIT_TOL = 0.1
F32_LOGIT_TOL = 1e-5
SERVE_RUNS = 5                     # timed full-width serve runs
MLA_RUNS = 1                       # timed runs of phases 6, 8 and 9
LARGE_POOLS = 4                    # pools in turn at the large block plans
# the trace draws token ids from the vocabulary, so MiniCPM3's 73448
# ids give another trace than gemma's 256000 from one seed; with seed 0
# no child's prompt is an exact prefix of a live parent's (no COW copy),
# seed 1 shows a fork, a COW copy and a preemption from the trace alone
MLA_TRACE_SEED = 1
# the same engine settings over Qwen3's 151936 ids and DeepSeek-V2-Lite's
# 102400: the first seeds that show a COW copy, a preemption with
# swap-out and swap-in and (Qwen3) suffix prefill from the trace alone.
# The schedule depends on the prompts, not on the weights (no EOS), so a
# CPU run of a narrow model with the same vocabulary and blocks finds it.
QWEN_TRACE_SEED = 11
DS_TRACE_SEED = 2
# phase 6: the decode setups (CPU generator seeds) whose bfloat16 logits
# are held against the float32 step's on both paths
F32_SEEDS = tuple(range(5, 9))
# phases 8 and 9: the float32 step runs the first layers at full width
# (all 48 of Qwen3-30B-A3B's in float32 would take 122 GB)
F32_DEPTH = 4
# the resident decode tail's step reading: calls timed, and the tokens of
# blocks each of its 3 sequences holds ahead of the timed calls' appends
TAIL_CALLS = 10
TAIL_ROOM = 128
#: the card's name and power limit, as nvidia-smi printed them
CARD = "not read"

REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:243",
    "paged_attention_append": "src/repro/kernels/paged_attention.py:161",
    "paged_prefill_attention": "src/repro/kernels/paged_prefill.py:99",
    "copy_pool_blocks": "src/repro/kernels/block_copy.py:128",
    "gather_blocks": "src/repro/kernels/block_copy.py:67",
    "scatter_blocks": "src/repro/kernels/block_copy.py:96",
    "block_copy": "src/repro/kernels/block_copy.py:38",
    "tree_gather": "src/repro/kernels/tree_gather.py:53",
    "tree_block_sum": "src/repro/kernels/tree_gather.py:72",
    "tree_gather_rows": "src/repro/kernels/tree_gather.py:99",
}
SOURCES = {
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_attention_append": "src/repro_torch/kernels/csrc/paged_append.cu",
    "paged_prefill_attention": "src/repro_torch/kernels/csrc/paged_prefill.cu",
    "copy_pool_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "gather_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "scatter_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "block_copy": "src/repro_torch/kernels/csrc/block_copy.cu",
    "tree_gather": "src/repro_torch/kernels/csrc/tree_gather.cu",
    "tree_block_sum": "src/repro_torch/kernels/csrc/tree_gather.cu",
    "tree_gather_rows": "src/repro_torch/kernels/csrc/tree_gather.cu",
}
MAIN_PATH = ("paged_attention_append", "paged_prefill_attention",
             "copy_pool_blocks", "gather_blocks", "scatter_blocks")
MLA_PATH = ("paged_attention", "copy_pool_blocks", "gather_blocks",
            "scatter_blocks")
TREE_PATH = ("tree_gather", "tree_block_sum", "tree_gather_rows")
#: the kernels line, in the order of PERF.md's kernel table
TABLE_ORDER = ("paged_attention_append", "paged_prefill_attention",
               "copy_pool_blocks", "gather_blocks", "scatter_blocks",
               "block_copy", "paged_attention") + TREE_PATH
#: peak device memory of phase 7 (a 4 GB array, its 4 GB pool and a
#: 4 GB gather, with the comparisons' temporaries in 512 MB pieces)
TREE_PEAK_BYTES = 20 << 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def mark(phases, t_start):
    """Log the script's elapsed time at the end of ``phases``."""
    log(f"{phases} done at {time.perf_counter() - t_start:.1f} s")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def assert_close(name, got, want, tol):
    err = max_err(got, want)
    bad = ((got.float() - want.float()).abs()
           > tol + tol * want.float().abs()).sum().item()
    check(bad == 0 and torch.isfinite(got.float()).all().item(),
          f"{name}: {bad} elements outside tol {tol} (max err {err:.3e})")
    return err


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def time_ms(fn, iters=30, warmup=3, tries=5):
    """(device ms, wall ms) per call, as ``trace_ms`` reads them."""
    return trace_ms(fn, iters, warmup, tries)[:2]


def trace_ms(fn, iters=30, warmup=3, tries=5):
    """(device ms, wall ms, device ms of memory operations) per call.
    The last sums the trace's ``Memcpy``/``Memset`` activities.  Device
    time sums every GPU activity the calls launch (kernels and copies), read from a
    torch.profiler trace; wall time lies between CUDA events around the
    loop and includes the host's launch overhead when the host cannot
    keep the card busy.  A trace without device events is a failure.
    Each trace follows a warm-up cycle of the profiler.  Every call
    launches the same activities, so a trace whose count of device
    events is not a multiple of ``iters`` lost some or kept another
    trace's (H100 runs of this script read 0.8x the wall time of 4 GB
    kernels that keep the card busy, and 149 events of 30 calls of one
    kernel), as has one whose device time exceeds the wall time by more
    than the two loops' noise: it is traced again, up to ``tries``
    times in all.  When
    no trace is clean (a full-width decode step launches ~7,000 kernels
    a call, and its traces differ by up to 1%), the one with the most
    events within the wall time is used, and a line says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CUDA],
                   schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                    active=1, repeat=1))
    best = (0, 0.0, 0.0)
    for _ in range(tries):
        with torch.profiler.profile(**prof_kw) as prof:
            for _ in range(2):                  # warm-up cycle, traced one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        dev = sum(_device_us(e) for e in prof.key_averages()) / 1e3 / iters
        mem = sum(_device_us(e) for e in prof.key_averages()
                  if e.key.startswith(("Memcpy", "Memset"))) / 1e3 / iters
        if 0 < dev <= 1.1 * wall:
            if n % iters == 0:
                return dev, wall, mem
            best = max(best, (n, dev, mem))
        log(f"time_ms: the trace kept {n} device events of {iters} calls, "
            f"{dev:.4f} ms per call against {wall:.4f} ms of wall time; "
            f"tracing again")
    check(best[0] > 0, f"torch.profiler gave no usable trace of {iters} "
          f"calls")
    log(f"time_ms: no clean trace; using the one of {best[0]} device events "
        f"({best[1]:.4f} ms per call), which may have lost some")
    return best[1], wall, best[2]


def rotating(fn, args):
    """A call of ``fn`` on the next of ``args``, round and round: timed
    loops that must not find their data in the L2."""
    it = itertools.cycle(args)
    return lambda: fn(next(it))


# ---------------------------------------------------------------------------
# phase 2: small shapes and edges
# ---------------------------------------------------------------------------
def small_checks(ops, ref, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        B, KVH, G, HD, BT, MB = 4, 2, 4, 64, 16, 4
        NB = B * MB + 1
        tables = torch.randperm(NB, generator=g, device=dev)[: B * MB]
        tables = tables.reshape(B, MB).to(torch.int32)
        tables[3, 2:] = -1                              # NULL past the end
        lens = torch.tensor([0, MB * BT, 37, 20], dtype=torch.int32,
                            device=dev)                 # empty / full table
        for softcap, window in ((None, None), (30.0, None), (None, 9),
                                (50.0, 24)):
            q = rnd((B, KVH, G, HD), dtype)
            kn, vn = rnd((B, KVH, HD), dtype), rnd((B, KVH, HD), dtype)
            kp, vp = rnd((NB, BT, KVH, HD), dtype), rnd((NB, BT, KVH, HD),
                                                          dtype)
            ro, rk, rv = ref.paged_attention_append_ref(
                q, kn, vn, kp.clone(), vp.clone(), tables, lens,
                softcap=softcap, window=window)
            o, k, v = ops.paged_attention_append(
                q, kn, vn, kp, vp, tables, lens, softcap=softcap,
                window=window)
            torch.cuda.synchronize()
            assert_close(f"append {dtype} sc={softcap} w={window}", o, ro,
                         tol)
            check(torch.equal(k, rk) and torch.equal(v, rv),
                  f"append {dtype}: pools differ from the plain version")
            SQ = 12
            qs = rnd((B, SQ, KVH, G, HD), dtype)
            kl = torch.tensor([12, 64, 50, 20], dtype=torch.int32,
                              device=dev)
            st = torch.tensor([0, 52, 40, 16], dtype=torch.int32,
                              device=dev)            # rows past kv_len pad
            ro = ref.paged_prefill_attention_ref(qs, kp, vp, tables, kl, st,
                                                 softcap=softcap,
                                                 window=window)
            o = ops.paged_prefill_attention(qs, kp, vp, tables, kl, st,
                                            softcap=softcap, window=window)
            torch.cuda.synchronize()
            assert_close(f"prefill {dtype} sc={softcap} w={window}", o, ro,
                         tol)
        # paged_attention (#7): G <= 16 over two kv heads with a separate
        # V pool, and MLA's 40 heads over one 288-wide latent head whose
        # first 256 lanes are V; row 0 has no key and must give 0
        for KVHq, Gq, HDq, VDq, latent in ((2, 4, 64, 32, False),
                                           (1, 40, 288, 256, True)):
            for softcap, window in ((None, None), (30.0, None), (None, 9),
                                    (50.0, 24)):
                q = rnd((B, KVHq, Gq, HDq), dtype)
                kp = rnd((NB, BT, KVHq, HDq), dtype)
                vp = kp if latent else rnd((NB, BT, KVHq, VDq), dtype)
                kw = dict(softcap=softcap, window=window,
                          v_dim=VDq if latent else None)
                ro = ref.paged_attention_ref(q, kp, vp, tables, lens, **kw)
                o = ops.paged_attention(q, kp, vp, tables, lens, **kw)
                torch.cuda.synchronize()
                assert_close(f"paged_attention {dtype} G={Gq} "
                             f"latent={latent} sc={softcap} w={window}", o,
                             ro, tol)
                check(not o[0].float().any(),
                      "paged_attention: a zero-length row is not 0")
                # float32 output, as absorbed MLA asks for: no rounding
                ro = ref.paged_attention_ref(q, kp, vp, tables, lens,
                                             out_dtype=torch.float32, **kw)
                o = ops.paged_attention(q, kp, vp, tables, lens,
                                        out_dtype=torch.float32, **kw)
                torch.cuda.synchronize()
                check(o.dtype == torch.float32,
                      "paged_attention: float32 output asked, not given")
                assert_close(f"paged_attention {dtype} -> float32 G={Gq} "
                             f"latent={latent} sc={softcap} w={window}", o,
                             ro, F32_TOL)
        L, nb = 3, 10
        pool = rnd((L, nb, 8, 2, 5), dtype)
        src, dst = np.array([1, 7, 3]), np.array([0, 9, 4])
        want = ref.copy_pool_blocks_ref(pool.clone(), torch.from_numpy(src),
                                        torch.from_numpy(dst))
        check(torch.equal(ops.copy_pool_blocks(pool.clone(), src, dst), want),
              f"copy_pool_blocks {dtype}")
        check(torch.equal(ops.gather_blocks(pool, src),
                          ref.gather_blocks_ref(pool, torch.from_numpy(src))),
              f"gather_blocks {dtype}")
        payload = rnd((L, 3, 8, 2, 5), dtype)
        want = ref.scatter_blocks_ref(pool.clone(), torch.from_numpy(dst),
                                      payload)
        check(torch.equal(ops.scatter_blocks(pool.clone(), dst, payload),
                          want), f"scatter_blocks {dtype}")
        flat = rnd((nb, 3, 7), dtype)                   # 84-byte blocks
        want = ref.block_copy_ref(flat.clone(), torch.from_numpy(src),
                                  torch.from_numpy(dst))
        check(torch.equal(ops.block_copy(flat.clone(), src, dst), want),
              f"block_copy {dtype}")
    log("phase 2: small float32/bfloat16 shapes and edges match the plain "
        "versions (append, prefill, paged_attention at G 4 and 40 with "
        "latent V and float32 output, copy, gather, scatter, block_copy)")


def block_edge_checks(ops, ref, dev):
    """The block kernel (#3-#6) at its edges, with numpy ids: ids at the
    parameter block's cap - 1, cap and cap + 1 (a copy of 481 pairs
    carries 962 ids, uploaded from pinned memory), 42- and 84-byte blocks
    (not a multiple of 16), 320-byte blocks (below a chunk), one layer
    and 62 layers of 32 KB and 36,864-byte blocks, and pools whose base
    is not 16-byte aligned.  Every wrapper must equal its plain version bitwise; the
    staged path also runs under ``set_sync_debug_mode("error")``."""
    cap = ops.MAX_PARAM_IDS
    cases = [(2, (3, 7), torch.float32, cap - 1, 479, 0),
             (2, (3, 7), torch.float32, cap, 480, 0),
             (2, (3, 7), torch.float32, cap + 1, 481, 0),
             (3, (3, 7), torch.bfloat16, 3, 3, 0),
             (3, (5, 2, 8), torch.float32, 3, 2, 0),
             (1, (64, 1, 256), torch.bfloat16, 2, 2, 0),
             (62, (64, 288), torch.bfloat16, 2, 2, 0),
             (3, (64, 1, 256), torch.bfloat16, 4, 2, 1),
             (4, (5, 2, 8), torch.float32, 3, 2, 1)]
    rng = np.random.default_rng(16)
    for L, blk, dtype, ng, nc, offset in cases:
        what = f"{L} layers of {blk} {dtype}, {ng}/{nc} ids, +{offset}"
        NB = max(ng, 2 * nc) + 1
        numel = L * NB * int(np.prod(blk))
        base = torch.from_numpy(rng.standard_normal(numel + 1).astype(
            np.float32)).to(dev, dtype)
        pool = base[offset:offset + numel].view(L, NB, *blk)
        perm = rng.permutation(NB)
        gi, src, dst = perm[:ng], perm[:nc], perm[nc:2 * nc]
        want = ref.copy_pool_blocks_ref(pool.clone(), torch.from_numpy(
            src), torch.from_numpy(dst))
        check(torch.equal(ops.copy_pool_blocks(pool, src, dst), want),
              f"copy_pool_blocks ({what}) differs")
        check(torch.equal(ops.gather_blocks(pool, gi),
                          ref.gather_blocks_ref(pool,
                                                torch.from_numpy(gi))),
              f"gather_blocks ({what}) differs")
        payload = torch.from_numpy(rng.standard_normal(
            (L, ng, *blk)).astype(np.float32)).to(dev, dtype)
        want = ref.scatter_blocks_ref(pool.clone(), torch.from_numpy(gi),
                                      payload)
        check(torch.equal(ops.scatter_blocks(pool, gi, payload), want),
              f"scatter_blocks ({what}) differs")
        flat = pool[L - 1]
        want = ref.block_copy_ref(flat.clone(), torch.from_numpy(dst),
                                  torch.from_numpy(src))
        check(torch.equal(ops.block_copy(flat, dst, src), want),
              f"block_copy ({what}) differs")
        if ng > cap:
            no_sync("gather_blocks with staged ids",
                    lambda: ops.gather_blocks(pool, gi), "phase 2")
            no_sync("copy_pool_blocks with staged ids",
                    lambda: ops.copy_pool_blocks(pool, src, dst),
                    "phase 2")
    torch.cuda.synchronize()
    log(f"phase 2: the block kernels match their plain versions bitwise "
        f"({len(cases)} cases x 4 wrappers: {cap - 1}, {cap} and "
        f"{cap + 1} ids, 42-, 84- and "
        f"320-byte blocks, 1 and 62 layers of 32 KB and 36,864 B blocks, "
        f"unaligned pool bases)")


#: #1 and #2 in phase 2: (model, KVH, G, HD, MB, softcap, windows)
SPLIT_CASES = (
    ("gemma-2b", 1, 8, 256, 6, None, (None, 100, 128)),
    ("gemma-2b", 1, 8, 256, 64, None, (None, 100, 128)),
    ("gemma2-27b", 16, 2, 128, 64, 50.0, (None, 100, 128)),
    ("qwen3-30b-a3b", 4, 8, 128, 6, None, (None, 100, 128)),
    ("qwen3-30b-a3b", 4, 8, 128, 64, None, (None, 100, 128)),
    ("gemma3-27b", 16, 2, 128, 24, None, (None, 1024)),
    ("zamba2-2.7b", 32, 1, 80, 6, None, (None,)),
    ("zamba2-2.7b", 32, 1, 80, 64, None, (None,)),
    ("internvl2-1b", 2, 7, 64, 8, None, (None,)),
    ("internvl2-1b", 2, 7, 64, 64, None, (None,)),
    ("whisper-tiny", 6, 1, 64, 7, None, (None,)),
    ("whisper-tiny", 6, 1, 64, 64, None, (None,)),
)
#: models whose path runs #1 and never #2 (zamba2's shared attention
#: and whisper's decoder prefill over the whole prompt): their cases
#: skip the prefill checks
APPEND_ONLY = ("zamba2-2.7b", "whisper-tiny")


def split_edge_checks(ops, ref, dev):
    """The redesigned #1 and #2 at the widths of every GQA model served
    (64-token blocks): gemma-2b's (1 kv head, G 8, head_dim 256),
    gemma2-27b's (16 kv heads, G 2, head_dim 128, softcap 50),
    Qwen3-30B-A3B's (4 kv heads, G 8, head_dim 128), gemma3-27b's (16
    kv heads, G 2, head_dim 128, a 1024-token window), InternVL2-1B's (2
    kv heads, G 7 -- an odd group, so 16-row tiles straddle query
    positions -- head_dim 64) and, for #1 only, Zamba2-2.7B's (32 kv
    heads, G 1, head_dim 80) and Whisper-tiny's (6 kv heads, G 1,
    head_dim 64, a 7-block table: its 448-token context), float32 and
    bfloat16.  #1 at a 6-block table (the decode path's) and a 64-block
    one (4096 keys: many splits, some empty) -- a 24-block one at
    gemma3's window -- with lengths at every edge of a block and of the
    table (0, 1, BT - 1, BT, BT + 1, MB * BT - 1 and MB * BT, which drops
    the write), NULL entries, and windows starting inside a block (100)
    and on a block's edge (128); at the 1024 window, lengths that put
    its first key at 0, 1, 64 and 65.  The pools must equal the plain
    version's.  #2 over 37 queries (not a whole row tile), at a first
    prefill, a suffix ending a full table, queries past ``kv_len`` and,
    with a window, queries whose every key is masked (which must give
    0); at gemma3's window, suffixes that straddle its edge."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    BT, n = 64, 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for model, KVH, G, HD, MB, softcap, windows in SPLIT_CASES:
            lens = [0, 1, BT - 1, BT, BT + 1, MB * BT - 1, MB * BT]
            wide = [w for w in windows if w and w > 128]
            for w in wide:
                lens += [w - 1, w, w - 1 + BT, w + BT]
            B = len(lens)
            NB = B * MB + 1
            tables = torch.randperm(NB, generator=g, device=dev)[: B * MB]
            tables = tables.reshape(B, MB).to(torch.int32)
            tables[:2, 1:] = -1
            lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = rnd((B, KVH, G, HD), dtype)
            kn, vn = rnd((B, KVH, HD), dtype), rnd((B, KVH, HD), dtype)
            kp, vp = rnd((NB, BT, KVH, HD), dtype), rnd((NB, BT, KVH, HD),
                                                          dtype)
            for window in windows:
                what = (f"append {dtype} KVH {KVH} G {G} HD {HD} MB {MB} "
                        f"w={window}")
                ro, rk, rv = ref.paged_attention_append_ref(
                    q, kn, vn, kp.clone(), vp.clone(), tables, lens,
                    softcap=softcap, window=window)
                a, b = kp.clone(), vp.clone()
                o, k, v = ops.paged_attention_append(
                    q, kn, vn, a, b, tables, lens, softcap=softcap,
                    window=window)
                torch.cuda.synchronize()
                assert_close(what, o, ro, tol)
                check(torch.equal(k, rk) and torch.equal(v, rv),
                      f"{what}: pools differ from the plain version")
                n += 1
            if (MB > 8 and not wide) or model in APPEND_ONLY:
                continue
            SQ = 37
            qs = rnd((4, SQ, KVH, G, HD), dtype)
            if wide:                # suffixes across the window's edge
                kl, st = [1100, MB * BT, 1300, 1040], [1063, MB * BT - SQ,
                                                        1250, 1003]
                pwindows = (None,) + tuple(wide)
            else:
                kl, st = [37, MB * BT, 200, 64], [0, MB * BT - SQ, 190, 150]
                pwindows = (None, 48, 64)
            kl = torch.tensor(kl, dtype=torch.int32, device=dev)
            st = torch.tensor(st, dtype=torch.int32, device=dev)
            for window in pwindows:
                what = (f"prefill {dtype} KVH {KVH} G {G} HD {HD} "
                        f"w={window}")
                ro = ref.paged_prefill_attention_ref(
                    qs, kp, vp, tables[:4], kl, st, softcap=softcap,
                    window=window)
                o = ops.paged_prefill_attention(
                    qs, kp, vp, tables[:4], kl, st, softcap=softcap,
                    window=window)
                torch.cuda.synchronize()
                assert_close(what, o, ro, tol)
                if window is not None and not wide:
                    check(not o[3, -1].float().any(),
                          f"{what}: a fully masked query is not 0")
                n += 1
    log(f"phase 2: the split-key append and the tiled prefill match their "
        f"plain versions at {sorted({c[0] for c in SPLIT_CASES})}'s widths "
        f"(the append only at {list(APPEND_ONLY)}'s) "
        f"({n} cases: 6-, 24- and 64-block tables, lengths at every block "
        f"and table edge and around a 1024 window's edge, NULL entries, "
        f"windows inside and on block edges, 37-query suffixes with rows "
        f"past kv_len, fully masked rows and rows across the window's "
        f"edge); pools equal")


#: #1 at large blocks in phase 2: (model, KVH, G, HD, BT, B) over
#: LARGE_SEQ keys a row with identity tables -- Fig. 5's layouts (phase
#: 16): a 256-token block, the contiguous baseline's one block of 2048,
#: and at B 32 a 256-token block whose splits span two pieces
LARGE_SEQ = 2048
LARGE_BLOCK_CASES = (
    ("gemma-2b", 1, 8, 256, 256, 8),
    ("gemma-2b", 1, 8, 256, 2048, 8),
    ("gemma-2b", 1, 8, 256, 256, 32),
    ("qwen3-30b-a3b", 4, 8, 128, 256, 8),
)


def large_block_checks(ops, ref, dev):
    """#1 at blocks of 256 and 2048 tokens (a stage of a whole block
    overflows shared memory at head_dim 256; the kernel stages pieces of
    it): gemma-2b's widths (1 kv head, G 8, head_dim 256) and Qwen3's (4
    kv heads, G 8, head_dim 128), float32 and bfloat16, identity tables
    over 2048 keys a row, with lengths at every multiple of 64 and one
    either side (the split and piece edges; 2048 fills the table, which
    drops the write), B rows per launch.  Output and pools must equal
    the plain version's."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    n_calls, plans = 0, set()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for model, KVH, G, HD, BT, B in LARGE_BLOCK_CASES:
            MB = LARGE_SEQ // BT
            plans.add((model, BT, B) + ops.plan_decode_splits(B, KVH, MB, BT))
            tables = torch.arange(B * MB, dtype=torch.int32,
                                  device=dev).reshape(B, MB)
            edges = sorted({min(max(64 * k + d, 0), LARGE_SEQ)
                            for k in range(LARGE_SEQ // 64 + 1)
                            for d in (-1, 0, 1)})
            kp = rnd((B * MB, BT, KVH, HD), dtype)
            vp = rnd((B * MB, BT, KVH, HD), dtype)
            for i in range(0, len(edges), B):
                lens = (edges[i:i + B] + edges[:B])[:B]
                lens = torch.tensor(lens, dtype=torch.int32, device=dev)
                q = rnd((B, KVH, G, HD), dtype)
                kn, vn = rnd((B, KVH, HD), dtype), rnd((B, KVH, HD), dtype)
                what = (f"append {dtype} {model} BT {BT} B {B} lens "
                        f"{lens.tolist()}")
                ro, rk, rv = ref.paged_attention_append_ref(
                    q, kn, vn, kp.clone(), vp.clone(), tables, lens)
                o, k, v = ops.paged_attention_append(
                    q, kn, vn, kp.clone(), vp.clone(), tables, lens)
                torch.cuda.synchronize()
                assert_close(what, o, ro, tol)
                check(torch.equal(k, rk) and torch.equal(v, rv),
                      f"{what}: pools differ from the plain version")
                n_calls += 1
    log(f"phase 2: paged_attention_append at large blocks matches its plain "
        f"version in float32 and bfloat16 ({n_calls} calls; (model, BT, B, "
        f"splits, keys a split): {sorted(plans)}; identity tables over "
        f"{LARGE_SEQ} keys, lengths at every multiple of 64 and one either "
        f"side); pools equal")


def attention_edge_checks(ops, ref, dev):
    """The split-key ``paged_attention`` (#7) at one query head per kv
    head (4 kv heads, head_dim 128), GQA (2 kv heads, G 4, a separate
    32-wide V pool), MiniCPM3-4B's MLA latent mode (G 40 over one
    288-wide latent head, V its first 256 lanes) and DeepSeek-V2-Lite's
    (G 16 over a 576-wide latent, V its first 512), float32 and bfloat16,
    over 6- and 64-block tables (a split of one half block, or of several
    blocks), with lengths at every edge of a block, a split and the table
    (0, 1, BT - 1, BT, BT + 1, W - 1, W, W + 1, 2 W + 1, MB * BT - 1 and
    MB * BT), NULL entries past the first block of rows 0 and 1, no
    window, one starting inside a split (100) and one on a split's edge
    (W + 1 for the row of length 2 W + 1), softcap 30 in GQA mode, with
    and without the self term (a float32 score and value per row), in
    q's dtype and in float32; a row of length 0 with no self term must
    give 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    BT, B, n = 64, 11, 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for (KVH, G, HD, VD, latent), MB in itertools.product(
                ((4, 1, 128, 128, False), (2, 4, 64, 32, False),
                 (1, 40, 288, 256, True), (1, 16, 576, 512, True)),
                (6, 64)):
            S, W = ops.plan_decode_splits(B, KVH, MB, BT, G)
            lens = torch.tensor([0, 1, BT - 1, BT, BT + 1, W - 1, W, W + 1,
                                 2 * W + 1, MB * BT - 1, MB * BT],
                                dtype=torch.int32, device=dev)
            NB = B * MB + 1
            tables = torch.randperm(NB, generator=g, device=dev)[: B * MB]
            tables = tables.reshape(B, MB).to(torch.int32)
            tables[:2, 1:] = -1
            q, kp = rnd((B, KVH, G, HD), dtype), rnd((NB, BT, KVH, HD), dtype)
            vp = kp if latent else rnd((NB, BT, KVH, VD), dtype)
            selfs = (rnd((B, KVH, G), torch.float32) * 8,
                     rnd((B, KVH, VD), torch.float32))
            outs = (dtype,) if dtype == torch.float32 else (dtype,
                                                           torch.float32)
            for window, with_self, out_dtype in itertools.product(
                    (None, 100, W + 1), (False, True), outs):
                kw = dict(window=window, v_dim=VD if latent else None,
                          softcap=None if latent else 30.0,
                          out_dtype=out_dtype)
                if with_self:
                    kw.update(self_score=selfs[0], self_v=selfs[1])
                what = (f"paged_attention {dtype} -> {out_dtype} KVH {KVH} "
                        f"G {G} MB {MB} (splits {S} of {W}) w={window} "
                        f"self={with_self}")
                ro = ref.paged_attention_ref(q, kp, vp, tables, lens, **kw)
                o = ops.paged_attention(q, kp, vp, tables, lens, **kw)
                torch.cuda.synchronize()
                check(o.dtype == out_dtype, f"{what}: output dtype {o.dtype}")
                assert_close(what, o, ro, tol if out_dtype == dtype
                             else F32_TOL)
                if not with_self:
                    check(not o[0].float().any(),
                          f"{what}: a zero-length row is not 0")
                n += 1
    log(f"phase 2: the split-key paged_attention matches its plain version "
        f"({n} cases: G 1, 4, and 40 and 16 with MLA latent V of 256 and "
        f"512, 6- and 64-block "
        f"tables, lengths at every block, split and table edge, NULL "
        f"entries, windows inside and on a split's edge, the self term, "
        f"q's dtype and float32 output)")


def tree_small_checks(ops, ref, dev):
    """The three tree kernels against their plain versions at small
    shapes and at the edges: leaves of 7 and 13 elements (28/52 bytes in
    float32, 14/26 in bfloat16: no 16-byte multiple), pools whose base
    is 4 or 2 bytes past a 16-byte boundary, one leaf, repeated ids, an
    empty table (no launch), one row per block, and each block's first
    and last row.  Gathers must be equal; block sums within
    ``tree_scan.SUM_TOL`` of each leaf's sum|x|."""
    from repro_torch.bench.tree_scan import SUM_TOL

    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def ids(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        for nb, leaf in ((4, 128), (16, 256), (7, 512), (9, 1024), (5, 7),
                         (3, 13), (1, 8192)):
            flat = torch.randn(nb * leaf + 1, generator=g, device=dev)
            flat = flat.to(dtype)
            perm = torch.randperm(nb, generator=g, device=dev).to(torch.int32)
            for base in (0, 1):                     # aligned, unaligned
                leaves = flat[base:base + nb * leaf].view(nb, leaf)
                for table in (perm, perm[:-1], ids([nb - 1]),
                              ids([0, nb - 1, 0, 0, nb - 1])):
                    what = (f"{dtype} pool {nb}x{leaf} base +{base} "
                            f"table {table.tolist()[:8]}")
                    check(torch.equal(ops.tree_gather(leaves, table),
                                      ref.tree_gather_ref(leaves, table)),
                          f"tree_gather {what}")
                    got = ops.tree_block_sum(leaves, table)
                    want = ref.tree_block_sum_ref(leaves, table)
                    mag = ref.tree_gather_ref(leaves, table).float().abs()
                    check(bool(((got - want).abs()
                                <= SUM_TOL * mag.sum(1) + 1e-30).all()),
                          f"tree_block_sum {what}: max err "
                          f"{max_err(got, want):.3e}")
        leaves = flat[: 3 * 7].view(3, 7)
        before = ops.launch_counts()
        empty = ids([])
        out = (ops.tree_gather(leaves, empty),
               ops.tree_block_sum(leaves, empty),
               ops.tree_gather_rows(leaves.view(3, 1, 7), empty, ids([0]), 1))
        check([tuple(o.shape) for o in out] == [(0, 7), (0,), (0, 7)]
              and ops.launch_counts() == before,
              "an empty table gave a non-empty output or a launch")
        for rpb, width in ((1, 128), (8, 64), (16, 7), (8, 2048)):
            nb = 6
            pool = torch.randn((nb * rpb * width + 1,), generator=g,
                               device=dev).to(dtype)
            pool = pool[1:].view(nb, rpb, width) if width == 7 else \
                pool[:-1].view(nb, rpb, width)
            ltab = torch.randperm(nb, generator=g, device=dev).to(torch.int32)
            rand = torch.randint(0, nb * rpb, (17,), generator=g, device=dev)
            edge = [b * rpb for b in range(nb)] + \
                [b * rpb + rpb - 1 for b in range(nb)]
            for rows in (rand.to(torch.int32), ids(edge), ids([5, 5, 0, 5])):
                check(torch.equal(
                    ops.tree_gather_rows(pool, rows, ltab, rpb),
                    ref.tree_gather_rows_ref(pool, rows, ltab, rpb)),
                    f"tree_gather_rows {dtype} rpb {rpb} width {width} rows "
                    f"{rows.tolist()[:8]}")
    torch.cuda.synchronize()
    log("phase 2: tree_gather, tree_block_sum and tree_gather_rows match "
        "their plain versions (float32/bfloat16, leaves of 7-8192 "
        "elements, unaligned pools, one leaf, repeated ids, empty tables "
        "without a launch, 1-16 rows per block, first and last rows)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
#: work of one recorded call; phase 4 replays each kernel's heaviest
#: call (decode: most live rows, then most cached keys)
WORK = {
    "paged_attention": lambda a: (int((a[4] > 0).sum()), int(a[4].sum())),
    "paged_attention_append": lambda a: (int((a[6] > 0).sum()),
                                         int(a[6].sum())),
    "paged_prefill_attention": lambda a: (a[0].shape[0] * a[0].shape[1],
                                          int(a[4].sum())),
    "copy_pool_blocks": lambda a: len(a[1]),
    "gather_blocks": lambda a: len(a[1]),
    "scatter_blocks": lambda a: len(a[1]),
    "block_copy": lambda a: len(a[1]),
}


class Recorder:
    """Keeps the arguments of each wrapper's heaviest call during a
    serve run (small inputs cloned, pools by reference) so phase 4 can
    replay the kernels at exactly the shapes the main path gave them.
    Its clones and host syncs slow the run, so no timed run uses it."""

    def __init__(self, ops, names=MAIN_PATH):
        self.ops = ops
        self.last = {}
        self.work = {}
        self.orig = {n: getattr(ops, n) for n in names}

    @staticmethod
    def _keep(x):
        # tables and lengths may be updated in place by later steps (the
        # resident tables are); everything else is kept by reference
        if isinstance(x, torch.Tensor) and x.dtype == torch.int32:
            return x.clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    def install(self):
        for name, fn in self.orig.items():
            def wrapped(*args, _fn=fn, _name=name, **kw):
                w = WORK[_name](args)
                if _name not in self.work or w >= self.work[_name]:
                    self.work[_name] = w
                    self.last[_name] = ([self._keep(a) for a in args],
                                        dict(kw))
                return _fn(*args, **kw)
            setattr(self.ops, name, wrapped)

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def step_ledger(eng):
    """Records after every ``eng.step()`` each swap store's bytes out and
    in and the table-sync rows and bytes so far; returns the list."""
    stores = [eng.strategy.store]
    if hasattr(eng.strategy, "state_store"):
        stores.append(eng.strategy.state_store)
    out, step = [], eng.step

    def stepped():
        step()
        out.append((tuple((s.stats.swap_out_bytes, s.stats.swap_in_bytes)
                          for s in stores),
                    eng.table_rows_updated, eng.table_sync_bytes))
    eng.step = stepped
    return out


def count_decodes(eng):
    """Counts the calls of the engine's resident decode tail (one per
    decode step); returns the one-element list holding the count."""
    n, tail = [0], eng.strategy.decode_resident

    def counted(*args, **kw):
        n[0] += 1
        return tail(*args, **kw)
    eng.strategy.decode_resident = counted
    return n


def serve_record(eng, done, dt, counts, ledger, decodes):
    """What one serve run gives, for ``graphs_vs_eager``."""
    st = eng.stats
    toks = sum(len(r.generated) for r in done)
    return {"tokens": {r.rid: list(r.generated) for r in done},
            "toks": toks, "dt": dt, "rate": toks / dt,
            "preemptions": st["preemptions"],
            "saved": st["prefill_tokens_saved"], "ledger": list(ledger),
            "counts": counts, "decodes": decodes[0], "steps": eng.steps,
            "graphs": st["decode_graphs"]}


def graphs_vs_eager(phase, eager, runs, control, kernels):
    """The replayed decode graphs against the eager tail on one path: the
    first timed run (graphs) must give the recorded run's (eager) tokens
    for every request, preemptions, swap bytes and table-sync rows and
    bytes after every step, prefill tokens saved, steps, decode steps
    and kernel launches (those of ``kernels`` logged); every graph run
    must have captured each bucket it reached once, recaptured nothing
    and replayed every decode step.  Logs both tokens/s medians: the
    timed graph runs and the eager control run."""
    g = runs[0]
    check(g["tokens"] == eager["tokens"], f"{phase}: the replayed decode "
          f"graphs' tokens differ from the eager tail's")
    for key in ("preemptions", "saved", "ledger", "steps", "decodes",
                "counts"):
        check(g[key] == eager[key], f"{phase}: {key} differs between the "
              f"replayed graphs and the eager tail: {str(g[key])[:300]} vs "
              f"{str(eager[key])[:300]}")
    for i, r in enumerate(runs):
        gs = r["graphs"]
        check(gs.get("graphs") and gs["recaptures"] == 0
              and all(n == 1 for n in gs["captures"].values())
              and gs["replays"] == r["decodes"],
              f"{phase}: run {i}: decode graphs {gs} over {r['decodes']} "
              f"decode steps")
        log(f"{phase}: run {i}: decode graphs captured once per bucket "
            f"reached {sorted(gs['captures'])} in {gs['capture_s']:.4f} s "
            f"(graph pool {gs['pool_bytes']} B), {gs['replays']} replays")
    check(not control["graphs"].get("graphs"), f"{phase}: the control run "
          f"replayed graphs")
    launched = ", ".join(f"{k} {g['counts'][k]} times" for k in kernels)
    log(f"{phase}: replayed graphs (run 0) vs eager tail (the recorded "
        f"run): identical tokens for {len(g['tokens'])} requests, "
        f"preemptions {g['preemptions']}, prefill tokens saved {g['saved']}, "
        f"swap bytes and table-sync rows/bytes equal after each of "
        f"{len(g['ledger'])} steps (at the end {g['ledger'][-1]}), the same "
        f"kernel launches" + (f" ({launched})" if kernels else ""))
    rates = [r["rate"] for r in runs]
    net = [r["toks"] / (r["dt"] - r["graphs"]["capture_s"]) for r in runs]
    log(f"{phase}: tok/s median, replayed graphs "
        f"{float(np.median(rates)):.2f} ({len(runs)} runs, min "
        f"{min(rates):.2f}, max {max(rates):.2f}; "
        f"{float(np.median(net)):.2f} without each run's capture seconds), "
        f"eager tail {control['rate']:.2f} (1 run, the control); {CARD}")


def tail_step(model, params, dev, phase):
    """The engine's resident decode tail (``strategy.decode_resident``) on
    3 live sequences in the steady state (update width 0), replayed from
    its captured graph and run eagerly: wall ms per call (CUDA events
    around each call, the card idle before it; median of TAIL_CALLS),
    device ms per call (torch.profiler over TAIL_CALLS calls) and the
    idle share; then one capture's wall time (host clock, synchronised)
    and device time (torch.profiler: the warm-ups' work) and the graph
    pool's bytes.  Each sequence first holds blocks for TAIL_ROOM more
    tokens, so that every timed call appends into its own blocks."""
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for graphs in (True, False):
        eng = Engine(model, params, slots=4, max_seq=384, num_blocks=16,
                     eos_id=-1, watermark=0, prefill_budget=None,
                     decode_graphs=graphs, device=dev)
        g = torch.Generator(device="cpu")
        g.manual_seed(8)
        for rid, n in enumerate((40, 70, 100)):
            eng.submit(Request(rid=rid, prompt=torch.randint(
                2, model.cfg.vocab_size, (n,), generator=g).numpy(),
                max_new=64))
        for _ in range(3):
            eng.step()
        strat, tok = eng.strategy, eng._tok_dev
        for slot, req in eng.running.items():
            strat.extend(req.rid, req.tokens_held + TAIL_ROOM)
            strat.mark_dirty(slot)
        strat.sync_device_state_delta(eng.running)
        strat.decode_resident(params, tok)        # splices the grown rows
        rows, _ = strat.sync_device_state_delta(eng.running)
        check(rows == 0, f"{phase}: the tail's steady state re-spliced "
              f"{rows} slots")

        def fn():
            return strat.decode_resident(params, tok)
        for _ in range(2):
            fn()
        walls = []
        for _ in range(TAIL_CALLS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s.record()
            fn()
            e.record()
            e.synchronize()
            walls.append(s.elapsed_time(e))
        dev_ms, loop_ms, _ = trace_ms(fn, iters=TAIL_CALLS, warmup=0,
                                      tries=2)
        out[graphs] = (float(np.median(walls)), dev_ms, loop_ms)
        if graphs:
            strat.release_decode_graphs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            cap_wall = time.perf_counter() - t0
            pool = strat.graph_stats["pool_bytes"]
            strat.release_decode_graphs()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            cap_dev = sum(_device_us(e) for e in prof.key_averages()) / 1e3
            check(cap_dev > 0, f"{phase}: the capture's trace holds no "
                  f"device time")
            check(strat.graph_stats["captures"].get(0) == 3,
                  f"{phase}: the tail's captures {strat.graph_stats}")
        del eng, strat, tok, fn
    gc.collect()
    torch.cuda.empty_cache()
    (gw, gd, gl), (ew, ed, el) = out[True], out[False]
    log(f"{phase}: resident decode tail, 3 rows, steady state (width 0): "
        f"replayed graph {gw:.3f} ms wall (median of {TAIL_CALLS} calls; "
        f"{gl:.3f} back to back), {gd:.3f} ms device, idle share "
        f"{1 - gd / gw:.3f}; eager tail {ew:.3f} ms wall ({el:.3f} back to "
        f"back), {ed:.3f} ms device, idle share {1 - ed / ew:.3f}; replay "
        f"{ew / gw:.2f}x faster; one capture (width 0: the tail twice on a "
        f"side stream, then the capture) {cap_wall * 1e3:.1f} ms wall, "
        f"{cap_dev:.3f} ms device, graph pool {pool} B; {CARD}")


def full_width_config():
    from repro_torch.configs.base import get_config

    cfg = get_config("gemma_2b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.kv_block_tokens)
          == (18, 2048, 8, 1, 256, 16384, 256000, "bfloat16", 64),
          "gemma_2b config is not full width")
    return cfg


def serve_full_width(dev, ops, cfg):
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace
    from repro_torch.tree import leaves as tree_leaves

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in tree_leaves(params))
    log(f"phase 3: {cfg.name}, {nparams / 1e9:.3f} B parameters "
        f"({nparams * 2 / 2**30:.2f} GiB bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s")

    def engine(graphs):
        return Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                      eos_id=-1, watermark=0, prefill_budget=None,
                      decode_graphs=graphs, device=dev)

    def trace():
        return make_trace("prefixheavy", 12, cfg.vocab_size, seed=0,
                          mean_gap=2.0, tenants=2, max_new=32,
                          prompt_cap=192)

    def run(rec=None, graphs=True):
        eng, source = engine(graphs), trace()
        ledger, decodes = step_ledger(eng), count_decodes(eng)
        if rec is not None:
            rec.install()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(source, max_steps=100)
        forced = []
        if eng.arena.compactions == 0:
            forced.append(("compact_now", eng.compact_now()))
        if eng.preemptions == 0 and eng.running:
            eng.preempt_latest()
            forced.append(("preempt_latest", 1))
        done = eng.serve(source, max_steps=100_000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        if rec is not None:
            rec.remove()
        st = eng.stats
        toks = sum(len(r.generated) for r in done)
        check(len(done) == 12 and all(len(r.generated) == 32 for r in done),
              "not every request finished")
        check(st["prefix_hits"] > 0 and st["prefill_tokens_saved"] > 0,
              "no COW fork / suffix prefill")
        check(st["cow_copies"] > 0, "no COW copy")
        check(st["swap_outs"] > 0 and st["swap_ins"] > 0, "no swap-out/in")
        check(st["compactions"] > 0, "no compaction")
        for name in MAIN_PATH:
            check(counts[name] > 0, f"kernel {name} never launched on the "
                  f"path")
        eng.arena.assert_quiescent()
        check(not eng.running and not eng.sched.has_work,
              "engine not drained")
        return (eng, toks, dt, counts, st, forced,
                serve_record(eng, done, dt, counts, ledger, decodes))

    # untimed first run, on the eager tail: records the kernels'
    # arguments (with host syncs no capture allows) and warms every
    # shape (cuBLAS choices, allocator) that the timed runs meet
    rec = Recorder(ops)
    rec_eng, *_, eager = run(rec, graphs=False)
    log(f"phase 3: recorded run (eager tail): heaviest call per kernel "
        f"{json.dumps(rec.work)}")
    runs = []
    for i in range(SERVE_RUNS + 1):
        graphs = i < SERVE_RUNS
        eng, toks, dt, counts, st, forced, r = run(graphs=graphs)
        log(f"phase 3: run {i if graphs else 'control'}: served 12 "
            f"requests, {toks} tokens in {dt:.4f} s = {toks / dt:.2f} tok/s "
            f"over {eng.steps} steps (slots 4, 12 blocks of 64 tokens, "
            f"prefixheavy trace; decode tail "
            f"{'replayed graphs' if graphs else 'eager'}); phase split "
            f"(s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
        if i == 0:
            first = (counts, st, forced)
        runs.append(r)
        del eng
    counts, st, forced = first
    graphs_vs_eager("phase 3", eager, runs[:-1], runs[-1],
                    ("paged_attention_append",))
    log(f"phase 3: prefix hits {st['prefix_hits']}, prefill tokens saved "
        f"{st['prefill_tokens_saved']}, COW copies {st['cow_copies']}, "
        f"preemptions {st['preemptions']}, swap-outs {st['swap_outs']} "
        f"({st['swap_out_bytes']} B), swap-ins {st['swap_ins']} "
        f"({st['swap_in_bytes']} B), compactions {st['compactions']}, "
        f"forced {forced or 'nothing'}")
    log(f"phase 3: kernel launches on the main path (run 0) "
        f"{json.dumps(counts)}; arena quiescent after every run")
    gc.collect()
    torch.cuda.empty_cache()
    tail_step(model, params, dev, "phase 3")
    return model, params, rec_eng, counts, rec.last


# ---------------------------------------------------------------------------
# phase 4: main-path shapes, compare and time
# ---------------------------------------------------------------------------
def kernel_row(phase, name, launches, err, k, p, nbytes, flops, dtype, lib,
               what=""):
    """Log one kernel's reading and return its entry of the kernels
    line: ``k``, ``p`` and ``lib`` are (device ms, wall ms) per call of
    the kernel, its plain version and the library call (or None)."""
    b_ms, by = bound(nbytes, flops, dtype)
    lib_s = ("n/a" if lib is None
             else f"{lib[0]:.4f} ms ({lib[1]:.4f} ms per call)")
    log(f"{phase}: {name}{what}: max_abs_err {err:.3e}; device time kernel "
        f"{k[0]:.4f} ms ({k[1]:.4f} ms per call), plain {p[0]:.4f} ms "
        f"({p[1]:.4f} ms per call), library {lib_s}; bound {b_ms:.5f} ms "
        f"({by}; {nbytes} B, {flops} flop); launches on the path "
        f"{launches}")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": int(launches),
            "max_abs_err": err, "ms": k[0], "plain_ms": p[0],
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": None if lib is None else lib[0]}


def measure(ops, ref, last, counts):
    rows = [measure_append(ops, ref, last, counts, "phase 4"),
            measure_prefill(ops, ref, last, counts, "phase 4")]
    q = last["paged_attention_append"][0][0]
    long_append(ops, ref, q, last["paged_attention_append"][1])
    rows += block_moves(ops, ref, last, counts, "phase 4")
    large_plans(ops, ref, q.device, "phase 4", large_shape(last))
    return rows


def measure_append(ops, ref, last, counts, phase):
    """#1 at its heaviest recorded call: equal to its plain version (the
    pools too), timed beside it, SDPA and its bound, and called once
    under ``set_sync_debug_mode("error")``; returns its row."""
    F = torch.nn.functional
    (q, kn, vn, kp, vp, tables, lens), kw = last["paged_attention_append"]
    B, KVH, G, HD = q.shape
    NB, BT = kp.shape[:2]
    VD, MB = vp.shape[-1], tables.shape[1]
    kp, vp = kp.clone(), vp.clone()
    ro, rk, rv = ref.paged_attention_append_ref(q, kn, vn, kp.clone(),
                                                vp.clone(), tables, lens,
                                                **kw)
    o, k, v = ops.paged_attention_append(q, kn, vn, kp, vp, tables, lens,
                                         **kw)
    torch.cuda.synchronize()
    # empty slots all append into the sink block at offset 0: which row's
    # write lands there is unordered in both versions, so those rows and
    # that block are left out; every live row owns its tail block
    tail = tables.long()[torch.arange(B, device=q.device),
                         torch.clamp(lens.long() // BT, max=MB - 1)]
    key = tail * BT + lens.long() % BT
    shared = (key[:, None] == key[None, :]).sum(1) > 1
    own = ~shared
    check(bool(own.any()), "no live row in the recorded decode call")
    err = assert_close(f"append ({phase})", o[own], ro[own], BF16_TOL)
    keep = torch.ones(NB, dtype=torch.bool, device=q.device)
    keep[tail[shared]] = False
    check(torch.equal(k[keep], rk[keep]) and torch.equal(v[keep], rv[keep]),
          f"append pools differ ({phase})")
    ms = time_ms(lambda: ops.paged_attention_append(q, kn, vn, kp, vp,
                                                    tables, lens, **kw))
    pms = time_ms(lambda: ref.paged_attention_append_ref(
        q, kn, vn, kp, vp, tables, lens, **kw))
    n = torch.clamp(lens.long() + 1, max=MB * BT)
    keys = int(n.sum()) * KVH
    es = kp.element_size()
    nbytes = (q.numel() + kn.numel() + vn.numel() + o.numel()
              + kn.numel() + vn.numel()) * es + keys * (HD + VD) * es \
        + tables.numel() * 4 + lens.numel() * 4
    flops = 2 * keys * G * (HD + VD)
    # yardstick: SDPA over the same keys pre-gathered into dense (B, H, S)
    tbl = tables.long().clamp(min=0)
    S = MB * BT
    kd = kp[tbl].reshape(B, S, KVH, HD).transpose(1, 2)
    vd = vp[tbl].reshape(B, S, KVH, VD).transpose(1, 2)
    kd = kd.repeat_interleave(G, dim=1).contiguous()
    vd = vd.repeat_interleave(G, dim=1).contiguous()
    qd = q.reshape(B, KVH * G, 1, HD)
    mask = (torch.arange(S, device=q.device)[None, :]
            < n[:, None]).reshape(B, 1, 1, S)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=kw.get("scale")))
    no_sync("paged_attention_append", lambda: ops.paged_attention_append(
        q, kn, vn, kp, vp, tables, lens, **kw), phase)
    return kernel_row(phase, "paged_attention_append",
                      counts["paged_attention_append"], err, ms, pms, nbytes,
                      flops, kp.dtype, lib,
                      f" at the heaviest recorded call (B {B}, KVH {KVH}, G "
                      f"{G}, head_dim {HD}, {keys} keys)")


def measure_prefill(ops, ref, last, counts, phase):
    """#2 at its heaviest recorded call, as ``measure_append`` does #1."""
    F = torch.nn.functional
    (q, kp, vp, tables, kl, st), kw = last["paged_prefill_attention"]
    B, SQ, KVH, G, HD = q.shape
    BT, VD, MB = kp.shape[1], vp.shape[-1], tables.shape[1]
    ro = ref.paged_prefill_attention_ref(q, kp, vp, tables, kl, st, **kw)
    o = ops.paged_prefill_attention(q, kp, vp, tables, kl, st, **kw)
    torch.cuda.synchronize()
    err = assert_close(f"prefill ({phase})", o, ro, BF16_TOL)
    ms = time_ms(lambda: ops.paged_prefill_attention(q, kp, vp, tables, kl,
                                                     st, **kw))
    pms = time_ms(lambda: ref.paged_prefill_attention_ref(q, kp, vp, tables,
                                                          kl, st, **kw))
    qa = st.long()[:, None] + torch.arange(SQ, device=q.device)[None, :]
    valid = torch.minimum(qa + 1, kl.long()[:, None]).clamp(min=0)
    es = kp.element_size()
    nbytes = (q.numel() + o.numel()) * es \
        + int(kl.long().sum()) * KVH * (HD + VD) * es \
        + (tables.numel() + 2 * B) * 4
    flops = 2 * int(valid.sum()) * KVH * G * (HD + VD)
    S = MB * BT
    tbl = tables.long().clamp(min=0)
    kd = kp[tbl].reshape(B, S, KVH, HD).transpose(1, 2)
    vd = vp[tbl].reshape(B, S, KVH, VD).transpose(1, 2)
    kd = kd.repeat_interleave(G, dim=1).contiguous()
    vd = vd.repeat_interleave(G, dim=1).contiguous()
    qd = q.reshape(B, SQ, KVH * G, HD).transpose(1, 2).contiguous()
    kpos = torch.arange(S, device=q.device)
    mask = ((kpos[None, None, :] <= qa[:, :, None])
            & (kpos[None, None, :] < kl.long()[:, None, None]))[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=kw.get("scale")))
    no_sync("paged_prefill_attention", lambda: ops.paged_prefill_attention(
        q, kp, vp, tables, kl, st, **kw), phase)
    return kernel_row(phase, "paged_prefill_attention",
                      counts["paged_prefill_attention"], err, ms, pms, nbytes,
                      flops, kp.dtype, lib,
                      f" at the heaviest recorded call ({B} x {SQ} queries, "
                      f"KVH {KVH}, G {G}, head_dim {HD})")


def large_shape(last):
    """The recorded gather's pool widened to 128 blocks."""
    pool = last["gather_blocks"][0][0]
    return (pool.shape[0], 128, *pool.shape[2:])


def no_sync(name, fn, phase="phase 4"):
    """One call of ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``:
    a wrapper that synchronises with the host (``.item()``, ``.cpu()``, a
    blocking copy) raises, and the phase fails."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise SmokeFailure(f"{name} synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{phase}: {name} ran under set_sync_debug_mode('error'): no host "
        f"synchronisation")


def long_append(ops, ref, q_main, kw, phase="phase 4"):
    """#1 at the main path's widths over a 64-block table (4096 keys per
    row, every row nearly full), against its plain version and beside SDPA
    over the same keys pre-gathered: a log line, not a kernels row."""
    F = torch.nn.functional
    B, KVH, G, HD = q_main.shape
    dev, dtype = q_main.device, q_main.dtype
    BT, MB = 64, 64
    NB = B * MB + 1
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    q = torch.randn((B, KVH, G, HD), generator=g, device=dev).to(dtype)
    kn = torch.randn((B, KVH, HD), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, KVH, HD), generator=g, device=dev).to(dtype)
    kp = torch.randn((NB, BT, KVH, HD), generator=g, device=dev).to(dtype)
    vp = torch.randn((NB, BT, KVH, HD), generator=g, device=dev).to(dtype)
    tables = torch.randperm(NB, generator=g, device=dev)[: B * MB]
    tables = tables.reshape(B, MB).to(torch.int32)
    lens = torch.full((B,), MB * BT - 1, dtype=torch.int32, device=dev)
    ro, rk, rv = ref.paged_attention_append_ref(q, kn, vn, kp.clone(),
                                                vp.clone(), tables, lens, **kw)
    o, k, v = ops.paged_attention_append(q, kn, vn, kp, vp, tables, lens,
                                         **kw)
    torch.cuda.synchronize()
    err = assert_close("append at 4096 keys", o, ro, BF16_TOL)
    check(torch.equal(k, rk) and torch.equal(v, rv),
          "append at 4096 keys: pools differ")
    ms = time_ms(lambda: ops.paged_attention_append(q, kn, vn, kp, vp,
                                                    tables, lens, **kw))
    S = MB * BT
    kd = kp[tables.long()].reshape(B, S, KVH, HD).transpose(1, 2)
    vd = vp[tables.long()].reshape(B, S, KVH, HD).transpose(1, 2)
    kd = kd.repeat_interleave(G, dim=1).contiguous()
    vd = vd.repeat_interleave(G, dim=1).contiguous()
    qd = q.reshape(B, KVH * G, 1, HD)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, scale=kw.get("scale")))
    keys = B * KVH * S
    b_ms, by = bound(keys * 2 * HD * kp.element_size(),
                     2 * keys * G * 2 * HD, dtype)
    plan = ops.plan_decode_splits(B, KVH, MB, BT)
    log(f"{phase}: paged_attention_append at 4096 keys (B {B}, KVH {KVH}, "
        f"G {G}, head_dim {HD}, {MB}-block tables, splits {plan[0]} of {plan[1]} "
        f"keys): max_abs_err {err:.3e}; device time kernel {ms[0]:.4f} ms "
        f"({ms[1]:.4f} ms per call), SDPA over the pre-gathered keys "
        f"{lib[0]:.4f} ms ({lib[1]:.4f} ms per call); bound {b_ms:.5f} ms "
        f"({by})")


def long_mla(ops, ref, q_main, kw, phase="phase 6"):
    """#7 at the MLA path's widths over a 64-block table (4096 keys per
    row, every row nearly full, with the self term), against its plain
    version and beside SDPA over the same latent rows pre-gathered: a log
    line, not a kernels row."""
    F = torch.nn.functional
    B, KVH, G, HD = q_main.shape
    VD = int(kw["v_dim"])
    dev, dtype = q_main.device, q_main.dtype
    BT, MB = 64, 64
    NB = B * MB + 1
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    q = torch.randn((B, KVH, G, HD), generator=g, device=dev).to(dtype)
    pool = torch.randn((NB, BT, KVH, HD), generator=g, device=dev).to(dtype)
    tables = torch.randperm(NB, generator=g, device=dev)[: B * MB]
    tables = tables.reshape(B, MB).to(torch.int32)
    lens = torch.full((B,), MB * BT - 1, dtype=torch.int32, device=dev)
    kw = dict(kw, self_score=torch.randn((B, KVH, G), generator=g,
                                         device=dev),
              self_v=torch.randn((B, KVH, VD), generator=g, device=dev))
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, **kw)
    o = ops.paged_attention(q, pool, pool, tables, lens, **kw)
    torch.cuda.synchronize()
    err = assert_close("paged_attention at 4096 keys", o, ro,
                       F32_TOL if o.dtype == torch.float32 else BF16_TOL)
    ms = time_ms(lambda: ops.paged_attention(q, pool, pool, tables, lens,
                                             **kw))
    S = MB * BT
    lat = pool[tables.long()].reshape(B, S, KVH, HD).transpose(1, 2)
    kd = lat.repeat_interleave(G, dim=1).contiguous()
    vd = lat[..., :VD].repeat_interleave(G, dim=1).contiguous()
    qd = q.reshape(B, KVH * G, 1, HD)
    mask = (torch.arange(S, device=dev)[None, :]
            < lens.long()[:, None]).reshape(B, 1, 1, S)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=kw.get("scale")))
    keys = int(lens.sum()) * KVH
    b_ms, by = bound(keys * HD * pool.element_size(),
                     2 * keys * G * (HD + VD), dtype)
    plan = ops.plan_decode_splits(B, KVH, MB, BT, G)
    log(f"{phase}: paged_attention at 4096 keys (B {B}, G {G}, latent {HD}, "
        f"V {VD}, {MB}-block tables, splits {plan[0]} of {plan[1]} keys, "
        f"self term): max_abs_err {err:.3e}; device time kernel "
        f"{ms[0]:.4f} ms ({ms[1]:.4f} ms per call), SDPA over the "
        f"pre-gathered latent {lib[0]:.4f} ms ({lib[1]:.4f} ms per call); "
        f"bound {b_ms:.5f} ms ({by})")


def lib_copy(pools, src, dst, layered=True):
    """(device ms, wall ms) of the two-op copy ``pool[:, d] = pool[:, s]``
    (``pool[d] = pool[s]`` when not ``layered``), on ``pools`` in turn."""
    s_d = torch.from_numpy(np.asarray(src, np.int64)).to(pools[0].device)
    d_d = torch.from_numpy(np.asarray(dst, np.int64)).to(pools[0].device)
    if layered:
        def fn(pool):
            pool[:, d_d] = pool[:, s_d]
    else:
        def fn(pool):
            pool[d_d] = pool[s_d]
    return time_ms(rotating(fn, pools))


def log_split(phase, name, fn):
    dev, _, mem = trace_ms(fn)
    log(f"{phase}: {name} device time split: kernels {dev - mem:.4f} ms, "
        f"memory copies {mem:.4f} ms per call")


def block_moves(ops, ref, last, counts, phase):
    """Replay the copy, gather and scatter calls that a path's recorded
    run gave the block kernels, on that path's own pools: each must equal
    its plain version exactly.  Logs each call's device time split into
    kernels and memory copies.  Returns their kernels-line rows."""
    rows = []

    def row(name, k, p, nbytes, dtype, lib, what):
        rows.append(kernel_row(phase, name, counts[name], 0.0, k, p, nbytes,
                               0, dtype, lib, what))

    (pool, src, dst), _ = last["copy_pool_blocks"]
    src, dst = np.asarray(src), np.asarray(dst)
    a, b = pool.clone(), pool.clone()
    ops.copy_pool_blocks(a, src, dst)
    ref.copy_pool_blocks_ref(b, torch.from_numpy(src), torch.from_numpy(dst))
    check(torch.equal(a, b), f"{phase}: copy_pool_blocks differs from its "
          f"plain version")
    blk = pool[0, 0].numel() * pool.element_size()
    mv = 2 * len(src) * pool.shape[0] * blk
    ms = time_ms(lambda: ops.copy_pool_blocks(a, src, dst))
    log_split(phase, "copy_pool_blocks",
              lambda: ops.copy_pool_blocks(a, src, dst))
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    pms = time_ms(lambda: ref.copy_pool_blocks_ref(b, s_t, d_t))
    lib = lib_copy([b], src, dst)
    row("copy_pool_blocks", ms, pms, mv, pool.dtype, lib,
        f" ({len(src)} of {tuple(pool.shape)}, equal; library = "
        f"pool[:, d] = pool[:, s], two PyTorch ops)")
    no_sync("copy_pool_blocks", lambda: ops.copy_pool_blocks(a, src, dst),
            phase)
    no_sync("block_copy (one layer of the pool)",
            lambda: ops.block_copy(a[0], src, dst), phase)

    (pool, idx), _ = last["gather_blocks"]
    idx = np.asarray(idx)
    got = ops.gather_blocks(pool, idx)
    check(torch.equal(got, ref.gather_blocks_ref(pool, torch.from_numpy(idx))),
          f"{phase}: gather_blocks differs from its plain version")
    mv = 2 * got.numel() * got.element_size()
    ms = time_ms(lambda: ops.gather_blocks(pool, idx))
    log_split(phase, "gather_blocks", lambda: ops.gather_blocks(pool, idx))
    i_t = torch.from_numpy(idx)
    pms = time_ms(lambda: ref.gather_blocks_ref(pool, i_t))
    i_d = i_t.to(pool.device).long()
    lib = time_ms(lambda: torch.index_select(pool, 1, i_d))
    row("gather_blocks", ms, pms, mv, pool.dtype, lib,
        f" ({len(idx)} of {tuple(pool.shape)}, equal)")
    no_sync("gather_blocks", lambda: ops.gather_blocks(pool, idx), phase)

    (pool, idx, payload), _ = last["scatter_blocks"]
    idx = np.asarray(idx)
    payload = payload.to(pool.device)
    a, b = pool.clone(), pool.clone()
    ops.scatter_blocks(a, idx, payload)
    ref.scatter_blocks_ref(b, torch.from_numpy(idx), payload)
    check(torch.equal(a, b), f"{phase}: scatter_blocks differs from its "
          f"plain version")
    mv = 2 * payload.numel() * payload.element_size()
    ms = time_ms(lambda: ops.scatter_blocks(a, idx, payload))
    log_split(phase, "scatter_blocks",
              lambda: ops.scatter_blocks(a, idx, payload))
    i_t = torch.from_numpy(idx)
    pms = time_ms(lambda: ref.scatter_blocks_ref(b, i_t, payload))
    i_d = i_t.to(pool.device).long()
    lib = time_ms(lambda: b.index_copy_(1, i_d, payload))
    row("scatter_blocks", ms, pms, mv, pool.dtype, lib,
        f" ({len(idx)} into {tuple(pool.shape)}, equal)")
    no_sync("scatter_blocks", lambda: ops.scatter_blocks(a, idx, payload),
            phase)
    return rows


def large_plans(ops, ref, dev, phase, shape, copy=True):
    """The block kernels at plans far larger than a serve run's, on
    seeded bfloat16 pools of ``shape`` (L, NB, *blk): gather and scatter
    of 64 blocks (one 4096-token sequence of 64-token blocks) and, with
    ``copy``, a copy of 32 blocks to 32 disjoint ids.  Each must equal
    its plain version bitwise; each is timed beside its plain version,
    ``index_select`` / ``index_copy_`` / the two-op indexed copy, and its
    byte bound.  A timed loop takes ``LARGE_POOLS`` pools (and payloads)
    in turn, so that each call reads HBM: one plan's bytes (37.7 MB for
    gemma-2b's copy) would otherwise stay in the 50 MB L2 between calls.
    Log lines, not kernels rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    pools = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(LARGE_POOLS)]
    pool = pools[0]
    L, NB = shape[:2]
    perm = np.random.default_rng(7).permutation(NB)
    idx, src, dst = perm[:64], perm[64:96], perm[96:128]
    blk = pool[0, 0].numel() * pool.element_size()
    i_t = torch.from_numpy(idx)
    i_d = i_t.to(dev).long()

    def line(name, n, k, p, lib, lib_name):
        nbytes = 2 * n * L * blk
        b_ms, _ = bound(nbytes, 0, pool.dtype)
        log(f"{phase}: {name}, large plan ({n} blocks of {tuple(shape)} "
            f"bf16, {nbytes} B moved, {LARGE_POOLS} pools in turn, equal): "
            f"device time kernel {k[0]:.4f} ms ({k[1]:.4f} ms per call), "
            f"plain {p[0]:.4f} ms ({p[1]:.4f}), {lib_name} {lib[0]:.4f} ms "
            f"({lib[1]:.4f}); bound {b_ms:.5f} ms; kernel at "
            f"{b_ms / k[0]:.2f} of the bound")

    got = ops.gather_blocks(pool, idx)
    check(torch.equal(got, ref.gather_blocks_ref(pool, i_t)),
          f"{phase}: gather_blocks (large plan) differs")
    del got
    line("gather_blocks", len(idx),
         time_ms(rotating(lambda p: ops.gather_blocks(p, idx), pools)),
         time_ms(rotating(lambda p: ref.gather_blocks_ref(p, i_t), pools)),
         time_ms(rotating(lambda p: torch.index_select(p, 1, i_d), pools)),
         "index_select")
    payloads = [torch.randn((L, len(idx), *shape[2:]), generator=g,
                            device=dev).to(torch.bfloat16)
                for _ in range(LARGE_POOLS)]
    a, b = pool.clone(), pool.clone()
    ops.scatter_blocks(a, idx, payloads[0])
    ref.scatter_blocks_ref(b, i_t, payloads[0])
    check(torch.equal(a, b), f"{phase}: scatter_blocks (large plan) differs")
    pairs = list(zip(pools, payloads))
    line("scatter_blocks", len(idx),
         time_ms(rotating(lambda pp: ops.scatter_blocks(pp[0], idx, pp[1]),
                          pairs)),
         time_ms(rotating(lambda pp: ref.scatter_blocks_ref(pp[0], i_t,
                                                            pp[1]), pairs)),
         time_ms(rotating(lambda pp: pp[0].index_copy_(1, i_d, pp[1]),
                          pairs)),
         "index_copy_")
    del payloads, pairs
    if copy:
        a, b = pool.clone(), pool.clone()
        s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
        ops.copy_pool_blocks(a, src, dst)
        ref.copy_pool_blocks_ref(b, s_t, d_t)
        check(torch.equal(a, b),
              f"{phase}: copy_pool_blocks (large plan) differs")
        line("copy_pool_blocks", len(src),
             time_ms(rotating(lambda p: ops.copy_pool_blocks(p, src, dst),
                              pools)),
             time_ms(rotating(lambda p: ref.copy_pool_blocks_ref(p, s_t, d_t),
                              pools)),
             lib_copy(pools, src, dst), "pool[:, d] = pool[:, s] (two ops)")


# ---------------------------------------------------------------------------
# phase 5: kernel path vs plain path, end to end
# ---------------------------------------------------------------------------
def _decode_setup(model, dev, B, lens, width, seed):
    """A cache of ``B`` rows with tables for ``width + 64`` tokens, and
    seeded prompts of ``width`` tokens (``lens`` of them real)."""
    from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager

    kv = model.kv_config(max_seq=width + 64, batch=B)
    mgr = PagedKVManager(kv)
    tables = np.stack([(mgr.admit(i, width + 64), mgr.device_table(i))[1]
                       for i in range(B)])
    cache = PagedKVCache.create(kv, B, device=dev)
    cache.block_tables.copy_(torch.as_tensor(tables))
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    toks = torch.randint(2, model.cfg.vocab_size, (B, width), generator=g)
    return cache, toks.to(dev), torch.tensor(lens, dtype=torch.int32,
                                             device=dev)


def _clone_pools(cache):
    return dataclasses.replace(
        cache, k_pool=cache.k_pool.clone(),
        v_pool=None if cache.v_pool is None else cache.v_pool.clone())


class SelfLeftOut:
    """The plain path with one planted fault, the control reading of the
    full-width logits limit: decode attends over the cached tokens and
    leaves the new token out."""

    @staticmethod
    def paged_attention(q, k_pool, v_pool, tables, lens, self_score=None,
                        self_v=None, **kw):
        from repro_torch.kernels import ref
        return ref.paged_attention_ref(q, k_pool, v_pool, tables, lens, **kw)

    @staticmethod
    def paged_attention_append(q, k_new, v_new, k_pool, v_pool, tables, lens,
                               **kw):
        from repro_torch.kernels import ref
        ref.write_tail_rows(k_pool, k_new, tables, lens)
        ref.write_tail_rows(v_pool, v_new, tables, lens)
        return (ref.paged_attention_ref(q, k_pool, v_pool, tables, lens, **kw),
                k_pool, v_pool)


def step_gaps(model, params, dev, kernel, seed=5):
    """One full-width decode step on the kernel path, the plain path and
    the plain path with a planted fault (``SelfLeftOut``).  The kernel
    path must launch ``kernel`` once per layer and the plain paths never,
    give finite logits, and write the same layer-0 K/V (or latent) rows
    as the plain path (the later layers' rows carry the attention
    outputs' rounding).  Returns the kernel's and the fault's largest
    logit difference from the plain path, as fractions of the largest
    plain logit, the number of rows whose argmax agrees, the kernel
    path's (tokens, cache) for timing, and the kernel and plain paths'
    logits."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    plain = build_model(model.cfg, plain=True)
    faulty = build_model(model.cfg, plain=True)
    faulty.kernels = SelfLeftOut
    B, L = 3, model.cfg.num_layers
    cache, nxt = _prefilled(model, params, dev, seed)
    c2, c3 = _clone_pools(cache), _clone_pools(cache)
    ops.reset_launch_counts()
    lk, _ = model.decode_step(params, nxt, cache)
    n_kernel = ops.launch_counts()[kernel]
    lp, _ = plain.decode_step(params, nxt, c2)
    lf, _ = faulty.decode_step(params, nxt, c3)
    torch.cuda.synchronize()
    check(n_kernel == L and ops.launch_counts()[kernel] == n_kernel,
          f"the kernel path did not launch one {kernel} per layer, or the "
          f"plain path launched one")
    check(torch.isfinite(lk).all().item(), "non-finite kernel-path logits")
    check(torch.equal(cache.k_pool[0], c2.k_pool[0])
          and (cache.v_pool is None
               or torch.equal(cache.v_pool[0], c2.v_pool[0])),
          "the two paths wrote different layer-0 rows")
    top = float(lp.abs().max())
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    return (max_err(lk, lp) / top, max_err(lf, lp) / top, agree,
            (nxt, cache), (lk, lp))


def routing_gaps(model, params, dev, phase, rel, seed=5):
    """Where a MoE model's bfloat16 kernel-vs-plain gap comes from: on
    decode setup ``seed``, record each MoE layer's routed experts in the
    kernel and plain paths' decode steps, log how many (layer, row)
    routings differ and the first global layer where one does; then run
    the kernel path once more with every layer routed to the plain
    path's experts (its own router's weights over them) and log that
    step's gap from the plain path beside ``rel``, the free-routing
    gap.  No limit: the reading explains the gap."""
    from repro_torch.models import moe
    from repro_torch.models.api import build_model

    plain = build_model(model.cfg, plain=True)
    cache, nxt = _prefilled(model, params, dev, seed)
    c2, c3 = _clone_pools(cache), _clone_pools(cache)
    route, calls = moe.route, []

    def recording(router_w, x, e):
        out = route(router_w, x, e)
        calls.append(out[1])
        return out

    def forced(router_w, x, e):
        _, _, probs = route(router_w, x, e)
        experts = calls.pop(0)
        w = probs.gather(-1, experts)
        return w / w.sum(-1, keepdim=True).clamp(min=1e-9), experts, probs

    L = model.n_scan
    try:
        moe.route = recording
        model.decode_step(params, nxt, cache)
        lp, _ = plain.decode_step(params, nxt, c2)
        check(len(calls) == 2 * L, "a decode step did not route once per "
              "MoE layer")
        ek, ep = (torch.stack(c).sort(-1).values
                  for c in (calls[:L], calls[L:]))
        del calls[:L]
        moe.route = forced
        lf, _ = model.decode_step(params, nxt, c3)
    finally:
        moe.route = route
    differ = (ek != ep).any(-1)                            # (L, rows)
    layers = differ.any(-1).nonzero().flatten().tolist()
    first = "none" if not layers else f"global layer {model.n_dense + layers[0]}"
    forced_rel = max_err(lf, lp) / float(lp.abs().max())
    log(f"{phase}: {model.cfg.name} bfloat16 decode step (setup {seed}): "
        f"routed experts differ between the kernel and plain paths in "
        f"{int(differ.sum())} of {differ.numel()} (MoE layer, row) pairs, "
        f"over {len(layers)} of {L} MoE layers, first at {first}; kernel "
        f"path routed as the plain path: {forced_rel:.4e} of max |logit| "
        f"from the plain path (free routing: {rel:.4e})")
    del cache, c2, c3


def _prefilled(model, params, dev, seed):
    """Decode setup ``seed``: 3 rows prefilled with 150, 100 and 191 of
    192 seeded prompt tokens; returns (cache, each row's next token)."""
    cache, toks, lens = _decode_setup(model, dev, 3, [150, 100, 191], 192,
                                      seed)
    _, cache = model.prefill(params, toks, cache, lens)
    return cache, toks[torch.arange(3), lens.long() % 192]


def f32_distances(model, params, m32, p32, dev, seeds, phase):
    """For each decode setup of ``seeds``: how far the bfloat16 kernel
    path's and plain path's logits lie from the float32 plain step's
    (same weights, cast), as fractions of the largest float32 logit;
    logs each setup, both medians and in how many setups the kernel path
    is the farther.  Returns the two lists."""
    from repro_torch.models.api import build_model

    plain, plain32 = (build_model(m.cfg, plain=True) for m in (model, m32))
    ks, ps = [], []
    for seed in seeds:
        cache, nxt = _prefilled(model, params, dev, seed)
        c2 = _clone_pools(cache)
        lk, _ = model.decode_step(params, nxt, cache)
        lp, _ = plain.decode_step(params, nxt, c2)
        c32, nxt32 = _prefilled(m32, p32, dev, seed)
        l32, _ = plain32.decode_step(p32, nxt32, c32)
        check(torch.equal(nxt, nxt32), "the float32 setup differs")
        top = float(l32.abs().max())
        ks.append(max_err(lk, l32) / top)
        ps.append(max_err(lp, l32) / top)
        log(f"{phase}: setup {seed}: bfloat16 logits against the float32 "
            f"step's: kernel path {ks[-1]:.4e}, plain path {ps[-1]:.4e}")
        del cache, c2, c32
    far = sum(k > p for k, p in zip(ks, ps))
    log(f"{phase}: {model.cfg.name} ({model.cfg.num_layers} layers) bfloat16 "
        f"logits against the float32 step's over {len(seeds)} decode setups "
        f"(CPU generator seeds {seeds[0]}-{seeds[-1]}): median kernel path "
        f"{float(np.median(ks)):.4e}, plain path {float(np.median(ps)):.4e}; "
        f"the kernel path is the farther in {far} of {len(seeds)} (no limit)")
    return ks, ps


def logits_check(model, params, dev, kernel, phase, depth=None,
                 seeds=(5,)):
    """A full-width decode step, kernel path against plain path, in the
    served bfloat16 (within LOGIT_TOL; then the step's wall and device
    time and the device's idle share) and in float32 (within
    F32_LOGIT_TOL, which the planted fault must exceed; a MoE model's
    routing differences first, ``routing_gaps``) -- on the first
    ``depth`` layers where the float32 weights of all would not fit;
    then, on the float32 step's layers, each path's bfloat16 logits
    against the float32 step's, for each decode setup of ``seeds``.
    Returns the bfloat16 step's (device ms, wall ms)."""
    name, B, L = model.cfg.name, 3, model.cfg.num_layers
    rel, fault, agree, (nxt, cache), (lk, lp) = step_gaps(model, params,
                                                         dev, kernel)
    log(f"{phase}: full-width {name} decode step, kernel vs plain path: "
        f"{rel:.4e} of max |logit| (tol {LOGIT_TOL}), argmax agrees on "
        f"{agree}/{B} rows; control, plain path with the new token left "
        f"out: {fault:.4e}")
    check(rel <= LOGIT_TOL, "kernel-path logits differ from the plain path")
    if model.cfg.moe is not None:
        routing_gaps(model, params, dev, phase, rel)
    # a whole step's trace is never clean (see trace_ms): two tries
    dev_ms, wall_ms = time_ms(lambda: model.decode_step(params, nxt, cache),
                              iters=10, warmup=2, tries=2)
    log(f"{phase}: one full-width {name} decode step ({B} rows, {L} "
        f"layers): {wall_ms:.3f} ms wall, {dev_ms:.3f} ms of device "
        f"activity, device idle share {1 - dev_ms / wall_ms:.3f}")
    del nxt, cache, lk, lp
    m32, p32 = _cut(model, params, depth, torch.float32)
    rel, fault, agree, _, _ = step_gaps(m32, p32, dev, kernel)
    cut = "" if depth is None else f" (its first {depth} layers)"
    log(f"{phase}: full-width {name} decode step in float32{cut}, kernel vs "
        f"plain path: {rel:.4e} of max |logit| (tol {F32_LOGIT_TOL}), argmax "
        f"agrees on {agree}/{B} rows; control, plain path with the new "
        f"token left out: {fault:.4e} (must exceed the tol)")
    check(rel <= F32_LOGIT_TOL, "float32 kernel-path logits differ from the "
          "plain path")
    check(fault > F32_LOGIT_TOL, "the planted fault stays within the float32 "
          "logits limit, so the limit would not catch a wrong kernel")
    mb, pb = _cut(model, params, depth)
    f32_distances(mb, pb, m32, p32, dev, seeds, phase)
    del m32, p32
    torch.cuda.empty_cache()
    return dev_ms, wall_ms


def _cut(model, params, depth=None, dtype=None):
    """The same model on its first ``depth`` layers (all for None; the
    leading dense layers first), with its weights in ``dtype`` (None:
    views of the served weights, no copy)."""
    from repro_torch.models.api import build_model

    cfg = model.cfg
    depth = cfg.num_layers if depth is None else depth
    nd = min(model.n_dense, depth)

    def cast(tree, n=None):
        if isinstance(tree, dict):
            return {k: cast(v, n) for k, v in tree.items()}
        t = tree if n is None else tree[:n]
        return t if dtype is None else t.to(dtype)

    out = {k: cast(v) for k, v in params.items()
           if k not in ("layers", "dense_layers")}
    out["layers"] = cast(params["layers"], depth - nd)
    if model.n_dense:
        out["dense_layers"] = cast(params["dense_layers"], nd)
    cfg = dataclasses.replace(cfg, num_layers=depth, dtype=str(
        dtype or cfg.torch_dtype).replace("torch.", ""))
    return build_model(cfg), out


def reduced_checks(dev, arch, phase):
    """``arch.reduced()`` in float32 on the card: the kernel path's logits
    at every decode step within F32_TOL of the plain path's (random
    reduced weights make greedy tokens degenerate, so tokens alone would
    prove little), then an engine on each path decoding identical
    tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace

    cfg = get_config(arch).reduced()
    check(cfg.dtype == "float32", "reduced config is not float32")
    kmodel, pmodel = build_model(cfg), build_model(cfg, plain=True)
    params = kmodel.init(seed=3, device=dev)
    B, W = 3, 24
    cache, toks, lens = _decode_setup(kmodel, dev, B, [W, 13, 7], W, 6)
    _, cache = kmodel.prefill(params, toks, cache, lens)
    c2 = _clone_pools(cache)
    nk = npl = toks[torch.arange(B), lens.long() - 1]
    worst = 0.0
    for _ in range(12):
        lk, cache = kmodel.decode_step(params, nk, cache)
        lp, c2 = pmodel.decode_step(params, npl, c2)
        worst = max(worst, assert_close(f"reduced {arch} logits", lk, lp,
                                        F32_TOL))
        nk, npl = lk.argmax(-1), lp.argmax(-1)
        check(torch.equal(nk, npl), f"reduced {arch} greedy tokens differ")
    log(f"{phase}: reduced float32 {arch} on the card, kernel vs plain "
        f"path: logits within {F32_TOL} at each of 12 decode steps (max "
        f"|diff| {worst:.3e})")
    out = {}
    for plain in (False, True):
        model = pmodel if plain else kmodel
        eng = Engine(model, params, slots=3, max_seq=64, num_blocks=14,
                     eos_id=-1, watermark=0, prefill_budget=None, device=dev)
        eng.serve(make_trace("prefixheavy", 10, cfg.vocab_size, seed=4,
                             mean_gap=1.0, tenants=2, max_new=12,
                             prompt_cap=24), max_steps=10_000)
        eng.arena.assert_quiescent()
        out[plain] = ({r.rid: list(r.generated) for r in eng.done},
                      eng.stats)
    same = out[False][0] == out[True][0]
    st = out[False][1]
    log(f"{phase}: reduced float32 {arch} engine on the card, kernel vs "
        f"plain path: {'identical' if same else 'DIFFERENT'} tokens over "
        f"{len(out[False][0])} requests (prefix hits {st['prefix_hits']}, "
        f"preemptions {st['preemptions']})")
    check(len(out[False][0]) == 10, f"reduced {arch} engine did not finish")
    check(same, f"reduced float32 {arch} tokens differ between kernel and "
          f"plain path")


# ---------------------------------------------------------------------------
# phase 6: the MLA path (MiniCPM3-4B from a paged latent pool)
# ---------------------------------------------------------------------------
def mla_config():
    from repro_torch.configs.base import get_config

    cfg = get_config("minicpm3_4b")
    m = cfg.mla
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, m.q_lora_rank,
           m.kv_lora_rank, m.qk_rope_head_dim, m.qk_nope_head_dim,
           m.v_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
           cfg.kv_block_tokens, cfg.attention)
          == (62, 2560, 40, 768, 256, 32, 64, 64, 6400, 73448, "bfloat16",
              64, "mla"), "minicpm3_4b config is not full width")
    return cfg


def serve_paged(dev, ops, cfg, phase, path, trace_seed):
    """Serve full-width ``cfg`` through ``Engine.serve`` on phase 3's
    engine settings over a ``prefixheavy`` trace of ``trace_seed``: one
    recorded run on the eager tail, then ``MLA_RUNS`` timed runs on the
    replayed decode graphs and one on the eager tail (the control), the
    launch counters zeroed just before each and read just after; the
    first graph run must match the recorded run (``graphs_vs_eager``),
    then the resident tail's step is timed (``tail_step``).  Each run
    must show,
    from the trace alone, a prefix hit, a COW copy and a preemption with
    swap-out and swap-in of whole blocks, launch every kernel of ``path``
    and end with a quiescent Arena; the decode attention kernel (#7 for
    MLA, #1 for GQA) must launch once per layer per decode step, the
    other path's never, and a GQA model must save prefill tokens by
    suffix prefill (#2) where MLA recomputes a forked prompt.  Returns
    (model, params, run 0's counts, the recorded calls)."""
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace
    from repro_torch.tree import leaves as tree_leaves

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in tree_leaves(params))
    log(f"{phase}: {cfg.name}, {nparams / 1e9:.3f} B parameters "
        f"({nparams * 2 / 2**30:.2f} GiB bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    L = cfg.num_layers
    mla = cfg.attention == "mla"
    decode = "paged_attention" if mla else "paged_attention_append"
    never = (("paged_attention_append", "paged_prefill_attention") if mla
             else ("paged_attention",))

    def run(rec=None, graphs=True):
        eng = Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                     eos_id=-1, watermark=0, prefill_budget=None,
                     decode_graphs=graphs, device=dev)
        source = make_trace("prefixheavy", 12, cfg.vocab_size,
                            seed=trace_seed, mean_gap=2.0, tenants=2,
                            max_new=32, prompt_cap=192)
        ledger, steps = step_ledger(eng), count_decodes(eng)
        if rec is not None:
            rec.install()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.serve(source, max_steps=100_000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        if rec is not None:
            rec.remove()
        st = eng.stats
        blk = eng.mgr.config.swap_nbytes_per_block()
        toks = sum(len(r.generated) for r in done)
        check(len(done) == 12 and all(len(r.generated) == 32 for r in done),
              f"{phase}: not every request finished")
        check(eng.suffix_prefill != mla, f"{phase}: suffix prefill is "
              f"{'on' if mla else 'off'}")
        check(st["prefix_hits"] > 0, f"{phase}: no prefix hit")
        check(st["prefill_tokens_saved"] == 0 if mla
              else st["prefill_tokens_saved"] > 0,
              f"{phase}: {st['prefill_tokens_saved']} prefill tokens saved")
        check(st["cow_copies"] > 0, f"{phase}: no COW copy")
        check(st["preemptions"] > 0 and st["swap_outs"] > 0
              and st["swap_ins"] > 0, f"{phase}: no preemption with "
              f"swap-out/in")
        check(st["swap_out_bytes"] > 0 and st["swap_out_bytes"] % blk == 0
              and st["swap_in_bytes"] % blk == 0,
              f"{phase}: swap bytes are not whole blocks of {blk} B")
        check(counts[decode] == L * steps[0] and steps[0] > 0,
              f"{phase}: {decode} launched {counts[decode]} times over "
              f"{steps[0]} decode steps of {L} layers")
        check(all(counts[k] == 0 for k in never),
              f"{phase}: a kernel of the other attention path launched")
        for name in path:
            check(counts[name] > 0, f"{phase}: kernel {name} never launched")
        eng.arena.assert_quiescent()
        check(not eng.running and not eng.sched.has_work,
              f"{phase}: engine not drained")
        return (eng, toks, dt, counts, st, steps[0],
                serve_record(eng, done, dt, counts, ledger, steps))

    rec = Recorder(ops, path)
    *_, eager = run(rec, graphs=False)
    log(f"{phase}: recorded run (eager tail): heaviest call per kernel "
        f"{json.dumps(rec.work)}")
    runs = []
    for i in range(MLA_RUNS + 1):
        graphs = i < MLA_RUNS
        eng, toks, dt, counts, st, nsteps, r = run(graphs=graphs)
        log(f"{phase}: run {i if graphs else 'control'}: served 12 "
            f"requests, {toks} tokens in {dt:.4f} s = {toks / dt:.2f} tok/s "
            f"over {eng.steps} steps ({nsteps} decode steps; slots 4, 12 "
            f"blocks of 64 tokens, prefixheavy trace of seed {trace_seed}; "
            f"decode tail {'replayed graphs' if graphs else 'eager'}); "
            f"phase split (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
        if i == 0:
            first = (counts, st, nsteps, eng.mgr.config)
        runs.append(r)
        del eng
    counts, st, nsteps, kv = first
    graphs_vs_eager(phase, eager, runs[:-1], runs[-1], (decode,))
    log(f"{phase}: prefix hits {st['prefix_hits']}, prefill tokens saved "
        f"{st['prefill_tokens_saved']}, COW copies {st['cow_copies']}, "
        f"preemptions {st['preemptions']}, swap-outs {st['swap_outs']} "
        f"({st['swap_out_bytes']} B), swap-ins {st['swap_ins']} "
        f"({st['swap_in_bytes']} B) of {kv.swap_nbytes_per_block()} B "
        f"blocks, compactions {st['compactions']}, nothing forced")
    log(f"{phase}: kernel launches on the path (run 0) {json.dumps(counts)} "
        f"= {L} x {nsteps} decode steps of {decode}; arena quiescent after "
        f"every run; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    tail_step(model, params, dev, phase)
    return model, params, counts, rec.last


def measure_mla(ops, ref, last, counts):
    rows = [measure_latent(ops, ref, last, counts, "phase 6")]
    q, kw = last["paged_attention"][0][0], last["paged_attention"][1]
    long_mla(ops, ref, q, kw)

    # the block kernels at the MLA path's own shapes (62-layer pools of
    # latent blocks); the kernels line keeps gemma-2b's rows for them
    block_moves(ops, ref, last, counts, "phase 6")
    large_plans(ops, ref, q.device, "phase 6", large_shape(last), copy=False)

    # block_copy (#6): one layer of the latent pool, the recorded COW plan
    (lpool, src, dst), _ = last["copy_pool_blocks"]
    src, dst = np.asarray(src), np.asarray(dst)
    flat = lpool[0].clone()
    a, b = flat.clone(), flat.clone()
    ops.block_copy(a, src, dst)
    ref.block_copy_ref(b, torch.from_numpy(src), torch.from_numpy(dst))
    check(torch.equal(a, b), "block_copy (one latent layer) differs")
    blk = flat[0].numel() * flat.element_size()
    bms = time_ms(lambda: ops.block_copy(a, src, dst))
    log_split("phase 6", "block_copy", lambda: ops.block_copy(a, src, dst))
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    bpms = time_ms(lambda: ref.block_copy_ref(b, s_t, d_t))
    lib = lib_copy([b], src, dst, layered=False)
    # a log line: the kernels line takes #6 from phase 10, where a served
    # state-pool compaction launches it
    kernel_row(
        "phase 6", "block_copy", counts["block_copy"], 0.0, bms, bpms,
        2 * len(src) * blk, 0, flat.dtype, lib,
        f" on one layer of the latent pool ({tuple(flat.shape)}, {len(src)} "
        f"block(s) of {blk} B; the serving path copies all layers at once; "
        f"library = pool[d] = pool[s], two PyTorch ops)")
    return rows


def measure_latent(ops, ref, last, counts, phase):
    """#7 at its heaviest recorded call of an MLA path: equal to its
    plain version, timed beside it, SDPA and its bound, and called once
    under ``set_sync_debug_mode("error")``; returns its row."""
    F = torch.nn.functional
    (q, kp, vp, tables, lens), kw = last["paged_attention"]

    check(vp is kp and kw.get("v_dim") is not None
          and kw.get("self_score") is not None,
          "the recorded MLA call is not in latent mode with the self term")
    B, KVH, G, HD = q.shape
    NB, BT = kp.shape[:2]
    VD, MB = int(kw["v_dim"]), tables.shape[1]
    pool = kp.clone()
    ro = ref.paged_attention_ref(q, pool, pool, tables, lens, **kw)
    o = ops.paged_attention(q, pool, pool, tables, lens, **kw)
    torch.cuda.synchronize()
    # mla_decode asks for a float32 output: no rounding of it to compare
    err = assert_close(f"paged_attention ({phase})", o, ro,
                       F32_TOL if o.dtype == torch.float32 else BF16_TOL)
    ms = time_ms(lambda: ops.paged_attention(q, pool, pool, tables, lens,
                                             **kw))
    pms = time_ms(lambda: ref.paged_attention_ref(q, pool, pool, tables,
                                                  lens, **kw))
    n = torch.clamp(lens.long(), max=MB * BT)
    keys = int(n.sum()) * KVH
    es = pool.element_size()
    # V is the first VD lanes of the same latent rows: read once; the
    # self term's float32 score and value are read once too
    nbytes = q.numel() * es + o.numel() * o.element_size() \
        + keys * HD * es + tables.numel() * 4 + lens.numel() * 4 \
        + (kw["self_score"].numel() + kw["self_v"].numel()) * 4
    flops = 2 * keys * G * (HD + VD) + 2 * B * KVH * G * VD
    S = MB * BT
    tbl = tables.long().clamp(min=0)
    lat = pool[tbl].reshape(B, S, KVH, HD).transpose(1, 2)
    kd = lat.repeat_interleave(G, dim=1).contiguous()
    vd = lat[..., :VD].repeat_interleave(G, dim=1).contiguous()
    qd = q.reshape(B, KVH * G, 1, HD)
    mask = (torch.arange(S, device=q.device)[None, :]
            < n[:, None]).reshape(B, 1, 1, S)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=kw.get("scale")))
    S_, W_ = ops.plan_decode_splits(B, KVH, MB, BT, G)
    row = kernel_row(
        phase, "paged_attention", counts["paged_attention"], err, ms, pms,
        nbytes, flops, pool.dtype, lib,
        f" at the heaviest recorded call (B {B}, {int((lens > 0).sum())} "
        f"live rows, {keys} cached keys and the self term, G {G}, latent "
        f"{HD}, V {VD}, splits {S_} of {W_} keys; library = SDPA over the "
        f"pre-gathered latent, cached keys only)")
    no_sync("paged_attention", lambda: ops.paged_attention(
        q, pool, pool, tables, lens, **kw), phase)
    return row



# ---------------------------------------------------------------------------
# phases 8 and 9: MoE decoders (Qwen3-30B-A3B, DeepSeek-V2-Lite)
# ---------------------------------------------------------------------------
def qwen3_config():
    from repro_torch.configs.base import get_config

    cfg = get_config("qwen3_moe_30b_a3b")
    e = cfg.moe
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
           e.num_experts, e.top_k, e.d_ff_expert, cfg.vocab_size,
           cfg.tie_embeddings, cfg.qk_norm, cfg.dtype, cfg.kv_block_tokens)
          == (48, 2048, 32, 4, 128, 128, 8, 768, 151936, False, True,
              "bfloat16", 64), "qwen3_moe_30b_a3b config is not full width")
    return cfg


def deepseek_config():
    from repro_torch.configs.base import get_config

    cfg = get_config("deepseek_v2_lite_16b")
    m, e = cfg.mla, cfg.moe
    check((cfg.num_layers, e.first_dense_layers, cfg.d_model, cfg.num_heads,
           m.q_lora_rank, m.kv_lora_rank, m.qk_rope_head_dim,
           m.qk_nope_head_dim, m.v_head_dim, e.num_experts, e.top_k,
           e.d_ff_expert, e.num_shared_experts, cfg.d_ff, cfg.vocab_size,
           cfg.dtype, cfg.kv_block_tokens)
          == (27, 1, 2048, 16, None, 512, 64, 128, 128, 64, 6, 1408, 2,
              10944, 102400, "bfloat16", 64),
          "deepseek_v2_lite_16b config is not full width")
    return cfg


def moe_step(model, params, dev, phase, step_dev_ms):
    """The MoE feed-forward of one decode step -- every MoE layer on 3
    rows, the timed step's batch, of seeded activations -- timed on the
    card, its share of the step's device time, beside the least time of
    the bytes it must read: each layer's router and shared experts and
    the experts its rows route to (distinct ids of this run's routing),
    each weight read once.  One call runs under
    ``set_sync_debug_mode("error")``: the decode step's MoE layout takes
    every shape from T, k and E and never waits for the host."""
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.lm import layer_params
    from repro_torch.models.moe import moe_ffn, route

    cfg, e = model.cfg, model.cfg.moe
    d, f, B = cfg.d_model, e.d_ff_expert, 3
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    x = torch.randn((B, d), generator=g, device=dev)
    h = rmsnorm(x, torch.zeros(d, device=dev), gemma_style=True).to(
        cfg.torch_dtype)
    ffs = [layer_params(params["layers"], j)["ff"]
           for j in range(model.n_scan)]

    def step():
        for ff in ffs:
            moe_ffn(ff, h, cfg)

    dev_ms, wall_ms = time_ms(step, iters=10, warmup=2, tries=2)
    es = ffs[0]["wi"].element_size()
    routed = [int(torch.unique(route(ff["router"], h, e)[1]).numel())
              for ff in ffs]
    nbytes = sum(n * 3 * d * f * es for n in routed) + len(ffs) * (
        d * e.num_experts * 4 + 3 * d * e.d_ff_shared * es)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{phase}: MoE feed-forward of one decode step ({len(ffs)} layers x "
        f"{B} rows, top {e.top_k} of {e.num_experts}, replica layout): "
        f"device {dev_ms:.4f} ms ({wall_ms:.4f} ms wall), "
        f"{dev_ms / step_dev_ms:.3f} of the step's {step_dev_ms:.3f} ms of "
        f"device time; bound {b_ms:.4f} ms (bytes: {nbytes} B, "
        f"{sum(routed)} routed experts over the layers, "
        f"{min(routed)}-{max(routed)} a layer), "
        f"{b_ms / dev_ms:.3f} of it")
    no_sync("moe_ffn", lambda: moe_ffn(ffs[0], h, cfg), phase)
    return dev_ms, b_ms


def moe_path(dev, ops, ref, arch, cfg, phase, path, trace_seed):
    """Phase 8 (Qwen3-30B-A3B: GQA with qk-norm, #1 and #2) or 9
    (DeepSeek-V2-Lite: MLA on the latent pool, #7): serve the model at
    full width and depth, replay its attention kernels at their heaviest
    recorded calls, check a full-depth bfloat16 decode step between the
    kernel and plain paths and the float32 step on the first F32_DEPTH
    layers, time the MoE feed-forward of a decode step, and hold the
    ``reduced()`` float32 model to the plain path."""
    torch.cuda.empty_cache()
    model, params, counts, last = serve_paged(dev, ops, cfg, phase, path,
                                              trace_seed)
    mla = cfg.attention == "mla"
    if mla:
        measure_latent(ops, ref, last, counts, phase)
        q, kw = last["paged_attention"][0][0], last["paged_attention"][1]
        long_mla(ops, ref, q, kw, phase)
        del q, kw
    else:
        measure_append(ops, ref, last, counts, phase)
        measure_prefill(ops, ref, last, counts, phase)
        q, kw = (last["paged_attention_append"][0][0],
                 last["paged_attention_append"][1])
        long_append(ops, ref, q, kw, phase)
        del q, kw
    del last
    kernel = "paged_attention" if mla else "paged_attention_append"
    step_dev, _ = logits_check(model, params, dev, kernel, phase,
                               depth=F32_DEPTH)
    moe_step(model, params, dev, phase, step_dev)
    log(f"{phase}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params
    torch.cuda.empty_cache()
    reduced_checks(dev, arch, phase)


# ---------------------------------------------------------------------------
# phases 10-12: the constant-state paths (Mamba2-370M, Zamba2-2.7B, RWKV6-7B)
# ---------------------------------------------------------------------------
#: the published widths each state path must be served at: layers, d_model,
#: heads, kv heads, head_dim, d_ff, vocab, dtype, ssm kind, state_dim, ssm
#: head_dim, chunk, shared-attention period and LoRA rank
STATE_WIDTHS = {
    "mamba2_370m": (48, 1024, 16, 16, 64, 0, 50288, "bfloat16", "mamba2",
                    128, 64, 64, 0, 0),
    "zamba2_2p7b": (54, 2560, 32, 32, 80, 10240, 32000, "bfloat16",
                    "mamba2", 64, 64, 64, 6, 128),
    "rwkv6_7b": (32, 4096, 64, 64, 64, 14336, 65536, "bfloat16", "rwkv6",
                 64, 64, 64, 0, 0),
}
#: trace seeds: with 12 state blocks for 4 slots a constant-state pool
#: never runs out, so its preemption is forced (``FORCE_AT``); for
#: Zamba2's KV pool seed 1 is the first to preempt from the trace alone
#: (a CPU run of a narrow model with the same vocabulary and blocks shows
#: it: the schedule depends on the prompts, not on the weights)
STATE_TRACE_SEEDS = {"mamba2_370m": 0, "zamba2_2p7b": 1, "rwkv6_7b": 0}
FORCE_AT = 12                      # forced preempt_latest after this step
STATE_RUNS = 2                     # timed serve runs of each state path
STATE_PATH = ("block_copy",)
HYBRID_PATH = ("paged_attention_append", "copy_pool_blocks",
               "gather_blocks", "scatter_blocks", "block_copy")


def state_config(arch):
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    s = cfg.ssm
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, s.kind, s.state_dim,
           s.head_dim, s.chunk, cfg.shared_attn_every, cfg.shared_attn_lora)
          == STATE_WIDTHS[arch], f"{arch} config is not full width")
    return cfg


def _nbytes_of(params):
    from repro_torch.tree import leaves as tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def _state_setup(model, params, dev, B, lens, width, seed):
    """``B`` rows of ``width`` seeded prompt tokens (``lens`` of them
    real), prefilled from zero state (the hybrid also into a fresh KV
    cache); returns (state, each row's next token)."""
    from repro_torch.models.zamba2 import ZambaState

    if hasattr(model, "kv_config"):
        cache, toks, lens_t = _decode_setup(model, dev, B, lens, width, seed)
        state0 = ZambaState(*model.init_recurrent(B, device=dev), cache)
    else:
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        toks = torch.randint(2, model.cfg.vocab_size, (B, width),
                             generator=g).to(dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        state0 = model.init_state(B, device=dev)
    _, state = model.prefill(params, toks, state0, lens_t)
    return state, toks[torch.arange(B), lens_t.long() % width]


def _state_prefilled(model, params, dev, seed):
    """Decode setup ``seed``: 3 rows prefilled with 150, 100 and 191 of
    192 seeded prompt tokens, as ``_prefilled`` does for the decoders."""
    return _state_setup(model, params, dev, 3, [150, 100, 191], 192, seed)


def _as_float32(model, params):
    from repro_torch.models.api import build_model

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.float()

    return (build_model(dataclasses.replace(model.cfg, dtype="float32")),
            cast(params))


def serve_state(dev, ops, arch, phase):
    """Serve full-width ``arch`` through ``Engine.serve`` on phase 3's
    engine settings over a ``prefixheavy`` trace: one recorded run, then
    ``STATE_RUNS`` timed runs, the launch counters zeroed just before
    each and read just after.  Each run must finish every request, share
    no prefix, preempt (forced after ``FORCE_AT`` steps on a
    constant-state pool, which never runs out) with the swap-out and
    swap-in of whole state blocks, compact, launch every kernel of its
    path (#6 for the state pools; the hybrid also #1 once per shared-
    attention invocation per decode step and #3-#5 for its KV) and no
    other, and end with a quiescent Arena.  Returns (model, params, run
    0's counts, the recorded calls)."""
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace
    from repro_torch.tree import leaves as tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = state_config(arch)
    hybrid = cfg.family == "hybrid"
    path = HYBRID_PATH if hybrid else STATE_PATH
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in tree_leaves(params))
    blk = 4 * model.state_elems
    log(f"{phase}: {cfg.name}, {nparams / 1e9:.3f} B parameters "
        f"({_nbytes_of(params) / 2**30:.2f} GiB) initialised in "
        f"{time.perf_counter() - t0:.1f} s; one sequence's state block "
        f"{model.state_elems} float32 = {blk} B")
    G = getattr(model, "groups", 0)
    seed = STATE_TRACE_SEEDS[arch]

    def run(rec=None, graphs=True):
        eng = Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                     eos_id=-1, watermark=0, prefill_budget=None,
                     decode_graphs=graphs, device=dev)
        source = make_trace("prefixheavy", 12, cfg.vocab_size, seed=seed,
                            mean_gap=2.0, tenants=2, max_new=32,
                            prompt_cap=192)
        ledger, steps = step_ledger(eng), count_decodes(eng)
        if rec is not None:
            rec.install()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forced = "nothing"
        if not hybrid:
            eng.serve(source, max_steps=FORCE_AT)
            if eng.preemptions == 0 and eng.running:
                eng.preempt_latest()
                forced = f"preempt_latest after step {eng.steps}"
        done = eng.serve(source, max_steps=100_000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        if rec is not None:
            rec.remove()
        st = eng.stats
        sst = getattr(eng.strategy, "state_store", eng.strategy.store).stats
        toks = sum(len(r.generated) for r in done)
        check(len(done) == 12 and all(len(r.generated) == 32 for r in done),
              f"{phase}: not every request finished")
        check(not eng.share_prefixes and not eng.suffix_prefill
              and st["prefix_hits"] == 0, f"{phase}: a prefix was shared")
        check(st["preemptions"] > 0 and sst.swap_outs > 0
              and sst.swap_ins > 0, f"{phase}: no preemption with state "
              f"swap-out/in")
        check(sst.swap_out_bytes == sst.swap_outs * blk
              and sst.swap_in_bytes == sst.swap_ins * blk,
              f"{phase}: state swaps are not whole blocks of {blk} B")
        check(st["compactions"] > 0, f"{phase}: no compaction")
        for name in path:
            check(counts[name] > 0, f"{phase}: kernel {name} never launched")
        check(all(n == 0 for k, n in counts.items() if k not in path),
              f"{phase}: a kernel off the path launched: {counts}")
        check(steps[0] > 0 and (not hybrid
                                or counts["paged_attention_append"]
                                == G * steps[0]),
              f"{phase}: paged_attention_append launched "
              f"{counts['paged_attention_append']} times over {steps[0]} "
              f"decode steps of {G} shared-attention invocations")
        eng.arena.assert_quiescent()
        check(not eng.running and not eng.sched.has_work,
              f"{phase}: engine not drained")
        return (eng, toks, dt, counts, st, sst, steps[0], forced,
                serve_record(eng, done, dt, counts, ledger, steps))

    rec = Recorder(ops, path)
    *_, eager = run(rec, graphs=False)
    log(f"{phase}: recorded run (eager tail): heaviest call per kernel "
        f"{json.dumps(rec.work)}")
    runs = []
    for i in range(STATE_RUNS + 1):
        graphs = i < STATE_RUNS
        eng, toks, dt, counts, st, sst, nsteps, forced, r = run(
            graphs=graphs)
        log(f"{phase}: run {i if graphs else 'control'}: served 12 "
            f"requests, {toks} tokens in {dt:.4f} s = {toks / dt:.2f} tok/s "
            f"over {eng.steps} steps ({nsteps} decode steps; slots 4, 12 "
            f"blocks, prefixheavy trace of seed {seed}; decode tail "
            f"{'replayed graphs' if graphs else 'eager'}); phase split "
            f"(s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
        if i == 0:
            first = (counts, st, sst, nsteps, forced)
        runs.append(r)
        del eng
    counts, st, sst, nsteps, forced = first
    graphs_vs_eager(phase, eager, runs[:-1], runs[-1],
                    ("paged_attention_append",) if hybrid else ())
    log(f"{phase}: preemptions {st['preemptions']}, state swap-outs "
        f"{sst.swap_outs} ({sst.swap_out_bytes} B), swap-ins {sst.swap_ins} "
        f"({sst.swap_in_bytes} B) of {blk} B blocks, KV swap-outs "
        f"{st['swap_outs'] if hybrid else 0}, compactions "
        f"{st['compactions']} ({st['blocks_compacted']} blocks moved), "
        f"prefix hits {st['prefix_hits']}, forced {forced}")
    what = (f" = {G} x {nsteps} decode steps of paged_attention_append"
            if hybrid else "")
    log(f"{phase}: kernel launches on the path (run 0) {json.dumps(counts)}"
        f"{what}; arena quiescent after every run; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    tail_step(model, params, dev, phase)
    return model, params, counts, rec.last


def measure_state_copy(ops, ref, last, counts, phase):
    """#6 at the recorded state-pool compaction: bitwise equal to its
    plain version, timed beside it, the two-op copy ``pool[d] = pool[s]``
    and its bound, its device time split, and called once under
    ``set_sync_debug_mode("error")``; returns its row."""
    (pool, src, dst), _ = last["block_copy"]
    src, dst = np.asarray(src), np.asarray(dst)
    a, b = pool.clone(), pool.clone()
    ops.block_copy(a, src, dst)
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    ref.block_copy_ref(b, s_t, d_t)
    check(torch.equal(a, b), f"{phase}: block_copy differs from its plain "
          f"version on the state pool")
    blk = pool[0].numel() * pool.element_size()
    ms = time_ms(lambda: ops.block_copy(a, src, dst))
    log_split(phase, "block_copy", lambda: ops.block_copy(a, src, dst))
    no_sync("block_copy", lambda: ops.block_copy(a, src, dst), phase)
    pms = time_ms(lambda: ref.block_copy_ref(b, s_t, d_t))
    lib = lib_copy([b], src, dst, layered=False)
    row = kernel_row(
        phase, "block_copy", counts["block_copy"], 0.0, ms, pms,
        2 * len(src) * blk, 0, pool.dtype, lib,
        f" at the recorded compaction ({len(src)} of {tuple(pool.shape)} "
        f"float32 state blocks of {blk} B; library = pool[d] = pool[s], "
        f"two PyTorch ops)")
    del a, b
    return row


def state_round_trip(model, params, dev, phase):
    """One sequence served alone, then again preempted after 3 steps:
    its whole recurrent state makes one host round trip as one state
    block, and the resumed tokens equal the uninterrupted run's."""
    from repro_torch.serve.engine import Engine, Request

    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    prompt = torch.randint(2, model.cfg.vocab_size, (100,),
                           generator=g).numpy()
    blk = 4 * model.state_elems

    def serve(preempt):
        eng = Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                     eos_id=-1, watermark=0, prefill_budget=None, device=dev)
        eng.submit(Request(rid=0, prompt=prompt.copy(), max_new=8))
        if preempt:
            for _ in range(3):
                eng.step()
            eng.preempt_latest()
            eng.sync_transfers()
        eng.run(100)
        eng.arena.assert_quiescent()
        st = getattr(eng.strategy, "state_store", eng.strategy.store).stats
        return eng.done[0].generated, eng.preemptions, st

    want, _, _ = serve(False)
    got, n, st = serve(True)
    check(n == 1 and st.swap_outs == st.swap_ins == 1
          and st.swap_out_bytes == st.swap_in_bytes == blk,
          f"{phase}: the round trip did not move one {blk} B state block")
    check(got == want, f"{phase}: resumed tokens differ from the "
          f"uninterrupted run's")
    log(f"{phase}: preempted after 3 steps, swapped out as one {blk} B "
        f"state block and back: the resumed sequence's {len(got)} tokens "
        f"equal the uninterrupted run's")


def resident_no_sync(model, params, dev, phase):
    """The engine's whole resident decode step (row and table splice,
    state gather, decode, scatter-back, argmax) on the eager tail
    (``decode_graphs=False``; a capture, which fails on any host sync, is
    the replayed graphs' stronger check) under
    ``set_sync_debug_mode("error")``: once with every slot re-spliced
    (the row indices uploaded from pinned memory) and once in the steady
    state, on an engine serving 3 sequences for 3 steps first."""
    from repro_torch.serve.engine import Engine, Request

    eng = Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                 eos_id=-1, watermark=0, prefill_budget=None,
                 decode_graphs=False, device=dev)
    g = torch.Generator(device="cpu")
    g.manual_seed(8)
    for rid, n in enumerate((40, 70, 100)):
        eng.submit(Request(rid=rid, prompt=torch.randint(
            2, model.cfg.vocab_size, (n,), generator=g).numpy(), max_new=16))
    for _ in range(3):
        eng.step()
    strat = eng.strategy
    strat.mark_all_dirty()
    rows, _ = strat.sync_device_state_delta(eng.running)
    check(rows == eng.slots, f"{phase}: the re-splice did not cover every "
          f"slot")
    no_sync(f"{model.cfg.name} decode step (resident, {rows} slots "
            f"re-spliced)",
            lambda: strat.decode_resident(params, eng._tok_dev), phase)
    rows, _ = strat.sync_device_state_delta(eng.running)
    check(rows == 0, f"{phase}: the steady state re-spliced {rows} slots")
    no_sync(f"{model.cfg.name} decode step (resident, steady state)",
            lambda: strat.decode_resident(params, eng._tok_dev), phase)
    del eng


def hybrid_gaps(model, params, dev, seed=5):
    """``step_gaps`` for the hybrid: one full-width decode step on the
    kernel path, the plain path and the plain path with the planted
    fault; the kernel path must launch #1 once per shared-attention
    invocation and the plain paths never, give finite logits and write
    the same first-invocation K/V rows as the plain path.  Returns the
    kernel's and the fault's gap from the plain path (fractions of the
    largest plain logit), the rows whose argmax agrees, the kernel path's
    (tokens, state) and the kernel and plain paths' logits."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.zamba2 import ZambaState

    plain = build_model(model.cfg, plain=True)
    faulty = build_model(model.cfg, plain=True)
    faulty.kernels = SelfLeftOut
    st, nxt = _state_prefilled(model, params, dev, seed)
    s2, s3 = (ZambaState(st.conv, st.ssd, _clone_pools(st.kv))
              for _ in range(2))
    ops.reset_launch_counts()
    lk, _ = model.decode_step(params, nxt, st)
    n = ops.launch_counts()["paged_attention_append"]
    lp, _ = plain.decode_step(params, nxt, s2)
    lf, _ = faulty.decode_step(params, nxt, s3)
    torch.cuda.synchronize()
    check(n == model.groups
          and ops.launch_counts()["paged_attention_append"] == n,
          "the kernel path did not launch one paged_attention_append per "
          "shared-attention invocation, or the plain path launched one")
    check(torch.isfinite(lk).all().item(), "non-finite kernel-path logits")
    check(torch.equal(st.kv.k_pool[0], s2.kv.k_pool[0])
          and torch.equal(st.kv.v_pool[0], s2.kv.v_pool[0]),
          "the two paths wrote different first-invocation K/V rows")
    top = float(lp.abs().max())
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    return (max_err(lk, lp) / top, max_err(lf, lp) / top, agree, (nxt, st),
            (lk, lp))


def state_logits(model, params, dev, phase):
    """A full-width decode step: for the hybrid, kernel path against
    plain path in bfloat16 (within LOGIT_TOL) and in float32 (within
    F32_LOGIT_TOL, which the planted fault must exceed); its wall and
    device time and the device's idle share; the engine's resident step
    under ``set_sync_debug_mode("error")``; and the bfloat16 logits
    against the float32 step's over all layers (logged, no limit)."""
    name, B, L = model.cfg.name, 3, model.cfg.num_layers
    hybrid = hasattr(model, "kv_config")
    if hybrid:
        rel, fault, agree, (nxt, st), (lk, _) = hybrid_gaps(model, params,
                                                           dev)
        log(f"{phase}: full-width {name} decode step, kernel vs plain path: "
            f"{rel:.4e} of max |logit| (tol {LOGIT_TOL}), argmax agrees on "
            f"{agree}/{B} rows; control, plain path with the new token left "
            f"out: {fault:.4e}")
        check(rel <= LOGIT_TOL, "kernel-path logits differ from the plain "
              "path")
    else:
        st, nxt = _state_prefilled(model, params, dev, 5)
        lk, _ = model.decode_step(params, nxt, st)
    check(torch.isfinite(lk).all().item(), f"{phase}: non-finite logits")
    # a whole step's trace is never clean (see trace_ms): two tries
    dev_ms, wall_ms = time_ms(lambda: model.decode_step(params, nxt, st),
                              iters=10, warmup=2, tries=2)
    log(f"{phase}: one full-width {name} decode step ({B} rows, {L} "
        f"layers): {wall_ms:.3f} ms wall, {dev_ms:.3f} ms of device "
        f"activity, device idle share {1 - dev_ms / wall_ms:.3f}")
    resident_no_sync(model, params, dev, phase)
    del st
    m32, p32 = _as_float32(model, params)
    if hybrid:
        rel, fault, agree, _, (_, l32) = hybrid_gaps(m32, p32, dev)
        log(f"{phase}: full-width {name} decode step in float32, kernel vs "
            f"plain path: {rel:.4e} of max |logit| (tol {F32_LOGIT_TOL}), "
            f"argmax agrees on {agree}/{B} rows; control, plain path with "
            f"the new token left out: {fault:.4e} (must exceed the tol)")
        check(rel <= F32_LOGIT_TOL, "float32 kernel-path logits differ from "
              "the plain path")
        check(fault > F32_LOGIT_TOL, "the planted fault stays within the "
              "float32 logits limit, so the limit would not catch a wrong "
              "kernel")
    else:
        st32, nxt32 = _state_prefilled(m32, p32, dev, 5)
        check(torch.equal(nxt, nxt32), "the float32 setup differs")
        l32, _ = m32.decode_step(p32, nxt32, st32)
        del st32
    top = float(l32.abs().max())
    agree = int((lk.argmax(-1) == l32.argmax(-1)).sum())
    log(f"{phase}: {name} bfloat16 decode-step logits against the float32 "
        f"step's (same weights, all {L} layers): "
        f"{max_err(lk, l32) / top:.4e} of max |logit|, argmax agrees on "
        f"{agree}/{B} rows (no limit)")
    del m32, p32
    torch.cuda.empty_cache()


def state_reduced_checks(dev, arch, phase):
    """``arch.reduced()`` in float32, the card against the CPU on the same
    seeded weights: logits within F32_TOL at each of 12 decode steps
    after a prefill of mixed lengths and identical greedy tokens, then an
    engine on each decoding identical tokens over a trace."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace

    cfg = get_config(arch).reduced()
    check(cfg.dtype == "float32", "reduced config is not float32")
    model = build_model(cfg)
    p_cpu = model.init(seed=3, device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev)

    params = {"cpu": p_cpu, "card": to_dev(p_cpu)}
    logits = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        st, nxt = _state_setup(model, params[where], d, 3, [24, 13, 7], 24,
                               6)
        out = []
        for _ in range(12):
            lg, st = model.decode_step(params[where], nxt, st)
            out.append(lg.cpu())
            nxt = lg.argmax(-1)
        logits[where] = out
    worst = 0.0
    for lc, lg in zip(logits["cpu"], logits["card"]):
        worst = max(worst, assert_close(f"reduced {arch}, the card against "
                                        f"the CPU", lg, lc, F32_TOL))
        check(torch.equal(lg.argmax(-1), lc.argmax(-1)),
              f"reduced {arch} greedy tokens differ between the card and "
              f"the CPU")
    log(f"{phase}: reduced float32 {arch}, the card against the CPU: logits "
        f"within {F32_TOL} at each of 12 decode steps (max |diff| "
        f"{worst:.3e}), identical tokens")
    out = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        eng = Engine(model, params[where], slots=3, max_seq=64,
                     num_blocks=14, eos_id=-1, watermark=0,
                     prefill_budget=None, device=d)
        eng.serve(make_trace("prefixheavy", 10, cfg.vocab_size, seed=4,
                             mean_gap=1.0, tenants=2, max_new=12,
                             prompt_cap=24), max_steps=10_000)
        eng.arena.assert_quiescent()
        out[where] = {r.rid: list(r.generated) for r in eng.done}
    check(len(out["card"]) == 10, f"reduced {arch} engine did not finish")
    check(out["card"] == out["cpu"], f"reduced float32 {arch} tokens differ "
          f"between the card and the CPU")
    log(f"{phase}: reduced float32 {arch} engine: identical tokens on the "
        f"card and the CPU over {len(out['card'])} requests")


def state_path(dev, ops, ref, arch, phase):
    """Phase 10 (Mamba2-370M), 11 (Zamba2-2.7B) or 12 (RWKV6-7B): serve
    the model at full width, replay #6 at the recorded state-pool
    compaction (and, for the hybrid, #1 and #3-#5 at their heaviest
    recorded calls), round-trip a preemption, check a full-width decode
    step, and hold the reduced float32 model on the card to the CPU.
    Returns #6's row."""
    marks = [("start", time.perf_counter())]
    model, params, counts, last = serve_state(dev, ops, arch, phase)
    marks.append(("serve", time.perf_counter()))
    row = measure_state_copy(ops, ref, last, counts, phase)
    if hasattr(model, "kv_config"):
        measure_append(ops, ref, last, counts, phase)
        block_moves(ops, ref, last, counts, phase)
    del last
    marks.append(("kernels", time.perf_counter()))
    state_round_trip(model, params, dev, phase)
    marks.append(("round trip", time.perf_counter()))
    state_logits(model, params, dev, phase)
    marks.append(("step", time.perf_counter()))
    log(f"{phase}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params
    torch.cuda.empty_cache()
    state_reduced_checks(dev, arch, phase)
    marks.append(("reduced", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))
    return row


# ---------------------------------------------------------------------------
# phase 7: the paper's data structures (TreeArray, paged rows)
# ---------------------------------------------------------------------------
def tree_path(ops):
    """Run the paper's experiments (Table 2, Fig. 4 and the paged row
    lookup) at every size up to 4 GB with the launch counters zeroed
    just before and read just after.  The benches themselves require
    every tree result to equal the dense one (see their docstrings).
    Returns the launch counts."""
    from repro_torch.bench import gups, tree_scan
    from repro_torch.core.treearray import TreeArray

    to_dense = TreeArray.to_dense
    calls = [0]

    def counted(self):
        calls[0] += 1
        return to_dense(self)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    TreeArray.to_dense = counted
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = tree_scan.run(dev) + gups.run(dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        TreeArray.to_dense = to_dense
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 7: Table 2 at {[l for l, _ in tree_scan.SIZES]}, GUPS at "
        f"{[l for l, _ in gups.SIZES]}, the chase and the paged rows in "
        f"{dt:.1f} s; peak device memory {peak / 2**30:.2f} GiB")
    for r in rows:
        if "err" in r:
            log(f"phase 7: {r['name']}: |tree - reference| {r['err']:.4e} "
                f"(tol {r['tol']:.4e})")
    us = {r["name"]: r["us"] for r in rows}
    for name in us:
        dense = re.sub(r"_tree(_iter|_naive)?", "_dense", name)
        if dense != name:
            log(f"phase 7: ratio {name} / {dense} = "
                f"{us[name] / us[dense]:.4f} ({us[name]:.2f} / "
                f"{us[dense]:.2f} us)")
    log(f"phase 7: kernel launches on the tree path {json.dumps(counts)}; "
        f"TreeArray.to_dense called {calls[0]} times")
    for name in TREE_PATH:
        check(counts[name] > 0, f"kernel {name} never launched on the tree "
              f"path")
    check(counts["tree_gather"] == calls[0],
          f"tree_gather launched {counts['tree_gather']} times for "
          f"{calls[0]} to_dense calls")
    check(all(v == 0 for k, v in counts.items() if k not in TREE_PATH),
          "a kernel off the tree path launched on it")
    check(peak <= TREE_PEAK_BYTES, f"phase 7 peaked at {peak} B of device "
          f"memory (limit {TREE_PEAK_BYTES})")
    return counts


def measure_tree(ops, ref, counts):
    """#8 and #9 at a 4 GB tree, #10 at the embedding lookup: each equal
    to (or, for the sums, within SUM_TOL of each leaf's sum|x| of) its
    plain version, timed beside it, its bound and a yardstick."""
    import torch.nn.functional as F
    from repro_torch.bench import gups, tree_scan
    from repro_torch.core.treearray import TreeArray

    dev = torch.device("cuda", 0)
    rows = []
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x = torch.randn(1 << 30, generator=g, device=dev)
    t = TreeArray.from_dense(x, leaf_size=tree_scan.LEAF,
                             fanout=tree_scan.FANOUT, shuffle_seed=1,
                             device=dev)
    del x
    leaves, table = t.leaves, t.leaf_table()
    nl, leaf, es = table.shape[0], t.leaf_size, leaves.element_size()
    shape = (f" at a {nl * leaf * es / 2**30:g} GiB tree ({nl} leaves of "
             f"{leaf} {leaves.dtype}, depth {t.depth}, shuffled)")

    got = ops.tree_gather(leaves, table)
    check(torch.equal(got, ref.tree_gather_ref(leaves, table)),
          "tree_gather (4 GB) differs from its plain version")
    tl = table.long()
    rows.append(kernel_row(
        "phase 7", "tree_gather", counts["tree_gather"], 0.0,
        time_ms(lambda: ops.tree_gather(leaves, table)),
        time_ms(lambda: ref.tree_gather_ref(leaves, table)),
        2 * nl * leaf * es + nl * 4, 0, leaves.dtype,
        time_ms(lambda: torch.index_select(leaves, 0, tl)),
        shape + ", equal; library = index_select"))

    ks = ops.tree_block_sum(leaves, table)
    ps = ref.tree_block_sum_ref(leaves, table)
    mag = torch.cat([c.abs().sum(1) for c in got.split(1 << 13)])
    err = max_err(ks, ps)
    check(bool(((ks - ps).abs() <= tree_scan.SUM_TOL * mag).all()),
          f"tree_block_sum (4 GB) differs from its plain version by {err}")
    dense = time_ms(lambda: got.sum(dim=1))
    rows.append(kernel_row(
        "phase 7", "tree_block_sum", counts["tree_block_sum"], err,
        time_ms(lambda: ops.tree_block_sum(leaves, table)),
        time_ms(lambda: ref.tree_block_sum_ref(leaves, table)),
        nl * leaf * es + 2 * nl * 4, nl * leaf, torch.float32, None,
        f"{shape}, within {tree_scan.SUM_TOL} of each leaf's sum|x|; dense "
        f"baseline, per-leaf sums of the contiguous array: {dense[0]:.4f} ms "
        f"({dense[1]:.4f} ms per call)"))
    del got, t, leaves, table, tl

    emb, pool, ltab, ids = gups.paged_rows_setup(dev, *gups.embedding_table())
    rpb = gups.ROWS_PER_BLOCK
    # the 4096 rows (16.8 MB) of one call would stay in the 50 MB L2
    # across timed calls; 16 seeded id sets (268 MB of rows) rotate so
    # each call reads HBM, as a lookup that finds the table cold does
    sets = [ids] + [torch.randint(0, emb.shape[0], ids.shape, generator=g,
                                  device=dev, dtype=ids.dtype)
                    for _ in range(15)]
    longs = [s.long() for s in sets]
    for s, sl in zip(sets, longs):
        got = ops.tree_gather_rows(pool, s, ltab, rpb)
        check(torch.equal(got, ref.tree_gather_rows_ref(pool, s, ltab, rpb))
              and torch.equal(got, F.embedding(sl, emb)),
              "tree_gather_rows differs from its plain version or the table")

    dense = time_ms(rotating(lambda sl: F.embedding(sl, emb), longs))
    n, W = got.shape
    rows.append(kernel_row(
        "phase 7", "tree_gather_rows", counts["tree_gather_rows"], 0.0,
        time_ms(rotating(lambda s: ops.tree_gather_rows(pool, s, ltab, rpb),
                         sets)),
        time_ms(rotating(lambda s: ref.tree_gather_rows_ref(pool, s, ltab,
                                                            rpb), sets)),
        2 * n * W * got.element_size() + 2 * n * 4, 0, got.dtype, None,
        f" ({n} rows of gemma-2b's {tuple(emb.shape)} {emb.dtype} embedding "
        f"table in blocks of {rpb} rows, shuffled, 16 id sets in turn; "
        f"equal; dense baseline, embedding on the contiguous table: "
        f"{dense[0]:.4f} ms ({dense[1]:.4f} ms per call))"))
    return rows


# ---------------------------------------------------------------------------
# phase 13: live migration, restart snapshot and disaggregated prefill
# ---------------------------------------------------------------------------
#: one gemma-2b KV block: 18 layers x 64 tokens x 1 KV head x 256 x 2 B,
#: K and V
GEMMA_BLOCK_BYTES = 18 * 64 * 1 * 256 * 2 * 2
#: one Mamba2-370M state block: 12,914,688 float32
MAMBA_BLOCK_BYTES = 4 * 12_914_688
MIGRATE_AT = 10                    # gemma-2b steps served before the move
MIGRATION_PATH = ("gather_blocks", "scatter_blocks")


def _tokens_of(done):
    return {r.rid: list(r.generated) for r in done}


def _restored_equal(payload, owners, dst, cls):
    """Whether ``dst``'s blocks, read through each restored mapping's
    fresh ids, hold ``payload`` (a ``gather_device_payload`` of the
    source) bit for bit; ``owners`` maps each source mapping's owner to
    its block ids at the gather."""
    ids, streams, _ = payload
    new_of = {}
    for owner, old in owners.items():
        new_of.update(zip(old, dst.arena.find_mapping(cls, owner)
                          .block_ids()))
    pools = dst.strategy._pools()
    new = torch.tensor([new_of[b] for b in ids], dtype=torch.long,
                       device=pools[0].device)
    return all(torch.equal(h.reshape(-1).view(torch.uint8),
                           p[:, new].cpu().contiguous().reshape(-1)
                           .view(torch.uint8))
               for h, p in zip(streams, pools))


def migrate_served(ops, make_engine, trace, at, tmp, phase, kv_check):
    """Serve ``trace`` on a control engine: ``at`` steps, one
    ``preempt_latest()``, then to the end.  On a second engine take the
    same first steps and preemption, ``migrate_live`` to a fresh engine
    and serve that one to the end: every request's tokens must equal the
    control's, the session must take 2+ rounds with a pause of one step,
    and both ends must hold their invariants.  With ``kv_check`` (a
    layered KV pool) the stop-and-copy tail must lie strictly under the
    first round, #4 and #5 must launch during the move, and the
    destination's blocks must hold a ``gather_device_payload`` of the
    source taken just before ``finalize`` bit for bit, a check that a
    restore of the snapshot with one byte flipped fails.  Logs rounds,
    bytes, the pause beside a stop-everything snapshot of the same
    state and its restore, and recaptures.  Returns the number of running rows moved."""
    from repro_torch.serve import disagg

    control, source = make_engine(), trace()
    control.serve(source, max_steps=at)
    control.preempt_latest()
    control.serve(source, max_steps=100_000)
    want = _tokens_of(control.done)
    check(len(want) == 12, f"{phase}: the control run did not finish")
    control.arena.assert_quiescent()
    control.release_arena()
    del control
    gc.collect()
    torch.cuda.empty_cache()

    src, source = make_engine(), trace()
    src.serve(source, max_steps=at)
    check(bool(src.running), f"{phase}: nothing runs at step {at}")
    src.preempt_latest()
    cls = src.strategy.mgr.pool_class
    t, seen = {}, {}

    class TimedSession(disagg.MigrationSession):
        def finalize(self, path):
            if kv_check:
                seen["payload"] = self.arena.gather_device_payload(cls)
                seen["owners"] = {m.owner: m.block_ids()
                                  for m in self.arena._cls(cls).mappings
                                  if m.placement == "device"}
            seen["running"] = len(src.running)
            torch.cuda.synchronize()
            t["finalize"] = time.perf_counter()
            out = super().finalize(path)
            t["finalized"] = time.perf_counter()
            return out

    def build():
        t0 = time.perf_counter()
        eng = make_engine()
        torch.cuda.synchronize()
        t["build"] = time.perf_counter() - t0
        restore = eng.arena.restore

        def timed_restore(path):
            t0 = time.perf_counter()
            out = restore(path)
            torch.cuda.synchronize()
            t["restore"] = time.perf_counter() - t0
            return out
        eng.arena.restore = timed_restore
        return eng

    path = str(tmp / f"{phase.replace(' ', '')}-live.npz")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    disagg.MigrationSession, plain_session = TimedSession, \
        disagg.MigrationSession
    try:
        dst, sess = disagg.migrate_live(src, build, path)
    finally:
        disagg.MigrationSession = plain_session
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = ops.launch_counts()
    rep = sess.migration_report()
    pause = t_end - t["finalize"] - t["build"]
    dst.arena.check_consistency()
    check(rep["rounds"] >= 2 and rep["pause_steps"] == 1,
          f"{phase}: migration report {rep}")
    if kv_check:
        check(0 < rep["stop_copy_blocks"] < rep["blocks_per_round"][0],
              f"{phase}: stop-and-copy tail {rep['stop_copy_blocks']} "
              f"blocks against {rep['blocks_per_round'][0]} in round 0")
        check(all(counts[k] > 0 for k in MIGRATION_PATH),
              f"{phase}: the migration launched {counts}")
        check(_restored_equal(seen["payload"], seen["owners"], dst, cls),
              f"{phase}: the destination's blocks differ from the "
              f"source's just before finalize")
        with np.load(path) as z:
            arrays = {k: z[k].copy() for k in z.files}
        key = f"device_{cls}_0"
        arrays[key][arrays[key].size // 2] ^= 0x10
        bad_path = str(tmp / f"{phase.replace(' ', '')}-flipped.npz")
        np.savez(bad_path, **arrays)
        del arrays
        bad = make_engine()
        bad.arena.restore(bad_path)
        check(not _restored_equal(seen["payload"], seen["owners"], bad, cls),
              f"{phase}: a snapshot with one flipped byte passed the "
              f"bitwise check")
        bad.release_arena()
        del bad
        log(f"{phase}: the destination's blocks equal a "
            f"gather_device_payload of the source taken just before "
            f"finalize, bit for bit, over {len(seen['payload'][0])} blocks; "
            f"the same check fails on a restore of the snapshot with one "
            f"byte flipped (planted fault caught)")
    live_bytes = len({b for m in src.arena._cls(cls).mappings
                      if m.placement == "device" for b in m.block_ids()}
                     ) * src.arena.block_nbytes(cls)
    full_path = str(tmp / f"{phase.replace(' ', '')}-full.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src.arena.snapshot(full_path, include_device=True)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    recap = src.strategy.graph_stats.get("recaptures", 0)
    src.release_arena()
    del src
    whole = make_engine()
    t0 = time.perf_counter()
    whole.arena.restore(full_path)
    torch.cuda.synchronize()
    full_restore_s = time.perf_counter() - t0
    whole.release_arena()
    del whole
    dst.serve(source, max_steps=dst.steps + 1)
    dst.check_consistency()         # the resumed slots' first step
    dst.serve(source, max_steps=100_000)
    got = _tokens_of(dst.done)
    check(got == want, f"{phase}: migrated tokens differ from the "
          f"control's for rids "
          f"{sorted(r for r in want if got.get(r) != want[r])}")
    dst.check_consistency()
    dst.arena.assert_quiescent()
    gs = dst.strategy.graph_stats
    dst.release_arena()
    del dst
    gc.collect()
    torch.cuda.empty_cache()
    moved = ", ".join(f"{k} {counts[k]}" for k in MIGRATION_PATH)
    log(f"{phase}: migrated mid-decode at step {at} ({seen['running']} rows "
        f"running, one preempted): {rep['rounds']} pre-copy rounds of "
        f"{rep['blocks_per_round']} blocks = {rep['bytes_per_round']} B, "
        f"stop-and-copy {rep['stop_copy_blocks']} blocks = "
        f"{rep['stop_copy_bytes']} B, pause steps {rep['pause_steps']}; "
        f"tokens identical to the control for {len(want)} requests; "
        f"launches during the move: {moved}")
    log(f"{phase}: pause {pause * 1e3:.1f} ms wall (finalize: stop-and-copy "
        f"and snapshot write {(t['finalized'] - t['finalize']) * 1e3:.1f} ms, "
        f"restore {t['restore'] * 1e3:.1f} ms, resume "
        f"{(pause - (t['finalized'] - t['finalize']) - t['restore']) * 1e3:.1f}"
        f" ms; the destination engine's build, {t['build'] * 1e3:.1f} ms, "
        f"not counted); snapshot {os.path.getsize(path)} B on disk; "
        f"stop-everything snapshot of the same state "
        f"(Arena.snapshot(include_device=True)) {full_s * 1e3:.1f} ms wall, "
        f"{live_bytes} B of device blocks, {os.path.getsize(full_path)} B on "
        f"disk, its restore {full_restore_s * 1e3:.1f} ms; decode-graph "
        f"recaptures on the source {recap}, on the "
        f"destination {gs.get('recaptures', 0)}; {CARD}")
    return seen["running"], rep


def disaggregated_prefill(ops, model, params, dev, base, phase):
    """The first requests of the trace through a ``PrefillWorker``
    (``slots=1``) and a ``DisaggregatedEngine`` on their arrival times,
    against a monolithic engine that admits one request per step (each
    prefill alone, the worker's shapes) with prefix sharing off, as on
    the worker: identical tokens, one handoff per request, whole blocks
    handed over, the worker's pool back to its sink, #4 and #5
    launched, and no recapture on the decode engine."""
    from repro_torch.serve.disagg import DisaggregatedEngine, PrefillWorker
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.traffic import RequestSource

    kw = dict(max_seq=384, eos_id=-1, watermark=0, prefill_budget=None,
              device=dev)

    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                        tenant=r.tenant, arrival_time=r.arrival_time)
                for r in base]

    mono = Engine(model, params, slots=4, num_blocks=24,
                  share_prefixes=False, **kw)
    for req in fresh():
        mono.submit(req)
        mono.step()
    mono.run(max_steps=100_000)
    want = _tokens_of(mono.done)
    mono.arena.assert_quiescent()
    mono.release_arena()
    del mono
    pre = PrefillWorker(model, params, num_blocks=12, **kw)
    dec = Engine(model, params, slots=4, num_blocks=24, **kw)
    dis = DisaggregatedEngine(pre, dec)
    steps_at = []
    adopt = dis.decode.adopt

    def adopted(*a, **k):
        steps_at.append(dec.steps)
        return adopt(*a, **k)
    dis.decode.adopt = adopted
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dis.serve(RequestSource(fresh()), max_steps=100_000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = _tokens_of(dis.done)
    cls = dec.strategy.mgr.pool_class
    bt = dec.strategy.block_tokens
    blocks = sum(-(-len(r.prompt) // bt) for r in base)
    gs = dec.strategy.graph_stats
    check(got == want, f"{phase}: disaggregated tokens differ from the "
          f"monolithic engine's")
    check(dis.handoffs == len(base) and pre.prefills == len(base),
          f"{phase}: {dis.handoffs} handoffs for {len(base)} requests")
    check(dec.arena.block_nbytes(cls) == GEMMA_BLOCK_BYTES
          and dis.handoff_bytes == blocks * GEMMA_BLOCK_BYTES,
          f"{phase}: {dis.handoff_bytes} B handed off for {blocks} blocks")
    check(pre.engine.arena.num_used(pre.engine.strategy.mgr.pool_class) == 1,
          f"{phase}: the prefill worker's pool holds more than its sink")
    check(all(counts[k] > 0 for k in MIGRATION_PATH),
          f"{phase}: the handoffs launched {counts}")
    check(gs.get("graphs") and gs["recaptures"] == 0,
          f"{phase}: decode graphs on the decode engine {gs}")
    check(all(r.t_first >= 0 for r in dis.done), f"{phase}: no TTFT stamp")
    dec.arena.assert_quiescent()
    log(f"{phase}: disaggregated prefill of {len(base)} requests (handed off "
        f"at decode steps {steps_at}): tokens identical to the monolithic "
        f"engine, {dis.handoffs} handoffs of {blocks} blocks = "
        f"{dis.handoff_bytes} B ({GEMMA_BLOCK_BYTES} B per block), the "
        f"worker's pool back to its sink, launches "
        + ", ".join(f"{k} {counts[k]}" for k in MIGRATION_PATH)
        + f", decode graphs captured {sorted(gs['captures'])} with "
        f"{gs['recaptures']} recaptures; served in {dt:.3f} s; {CARD}")
    for e in (pre.engine, dec):
        e.release_arena()
    del pre, dec, dis
    gc.collect()
    torch.cuda.empty_cache()


def replay_migration_kernels(ops, ref, last, phase):
    """#4 and #5 at the heaviest calls this phase gave them, against
    their plain versions, bit for bit."""
    (pool, idx), _ = last["gather_blocks"]
    idx = np.asarray(idx)
    check(torch.equal(ops.gather_blocks(pool, idx),
                      ref.gather_blocks_ref(pool, torch.from_numpy(idx))),
          f"{phase}: gather_blocks differs from its plain version")
    (spool, sidx, payload), _ = last["scatter_blocks"]
    sidx = np.asarray(sidx)
    a, b = spool.clone(), spool.clone()
    ops.scatter_blocks(a, sidx, payload)
    ref.scatter_blocks_ref(b, torch.from_numpy(sidx), payload)
    check(torch.equal(a, b), f"{phase}: scatter_blocks differs from its "
          f"plain version")
    torch.cuda.synchronize()
    log(f"{phase}: the heaviest recorded calls, gather_blocks ({len(idx)} of "
        f"{tuple(pool.shape)}) and scatter_blocks ({len(sidx)} into "
        f"{tuple(spool.shape)}), equal their plain versions bit for bit")


def migration_path(dev, ops, ref):
    """Phase 13: live migration of full-width gemma-2b mid-decode (the
    bitwise restore with its planted fault, the pause beside a
    stop-everything snapshot), its disaggregated prefill, and live
    migration of full-width Mamba2-370M's flat state pool; #4 and #5 at
    the heaviest calls of the phase against their plain versions."""
    import tempfile

    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace

    phase = "phase 13"
    marks = [("start", time.perf_counter())]
    rec = Recorder(ops, MIGRATION_PATH)
    rec.install()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase13-") as tmp:
        tmp = Path(tmp)
        cfg = full_width_config()
        model = build_model(cfg)
        params = model.init(seed=0, device=dev)

        def gemma_engine():
            return Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                          eos_id=-1, watermark=0, prefill_budget=None,
                          device=dev)

        def gemma_trace():
            return make_trace("prefixheavy", 12, cfg.vocab_size, seed=0,
                              mean_gap=2.0, tenants=2, max_new=32,
                              prompt_cap=192)

        migrate_served(ops, gemma_engine, gemma_trace, MIGRATE_AT, tmp,
                       phase, kv_check=True)
        marks.append(("gemma migration", time.perf_counter()))
        disaggregated_prefill(ops, model, params, dev,
                              gemma_trace()._trace[:4], phase)
        marks.append(("disaggregation", time.perf_counter()))
        del params, model
        gc.collect()
        torch.cuda.empty_cache()

        scfg = state_config("mamba2_370m")
        smodel = build_model(scfg)
        sparams = smodel.init(seed=0, device=dev)

        def mamba_engine():
            return Engine(smodel, sparams, slots=4, max_seq=384,
                          num_blocks=12, eos_id=-1, watermark=0,
                          prefill_budget=None, device=dev)

        def mamba_trace():
            return make_trace("prefixheavy", 12, scfg.vocab_size,
                              seed=STATE_TRACE_SEEDS["mamba2_370m"],
                              mean_gap=2.0, tenants=2, max_new=32,
                              prompt_cap=192)

        running, rep = migrate_served(ops, mamba_engine, mamba_trace,
                                      FORCE_AT, tmp, f"{phase} (Mamba2)",
                                      kv_check=False)
        log(f"{phase} (Mamba2): the stop-and-copy tail "
            f"{rep['stop_copy_bytes']} B against {running} running rows x "
            f"{MAMBA_BLOCK_BYTES} B = {running * MAMBA_BLOCK_BYTES} B: every "
            f"decode rewrites each running row's whole state block, so the "
            f"tail is the running set's whole state")
        del sparams, smodel
        marks.append(("Mamba2 migration", time.perf_counter()))
    rec.remove()
    replay_migration_kernels(ops, ref, rec.last, phase)
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("kernels", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))


# ---------------------------------------------------------------------------
# phase 14: training on the card
# ---------------------------------------------------------------------------
TRAIN_ARCHS = ("gemma_2b", "qwen3_moe_30b_a3b", "mamba2_370m")
TRAIN_B, TRAIN_S = 8, 256          # full-width gemma-2b: 2048 tokens a step
TRAIN_WARM, TRAIN_TIMED = 2, 8     # untimed, then timed steps
TRAIN_CUT = 2                      # layers of the float32 full-width check
ADAMW_BYTES = 22                   # per parameter: p, g bf16; m, v f32 r+w


def _grad_leaves(model, params, batch, **kw):
    """(loss, [(path, grad)]) of ``model.loss`` on ``batch``; the
    parameters are marked for autograd only while it runs."""
    from repro_torch.tree import flatten_with_paths

    paths, leaves, _ = flatten_with_paths(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = model.loss(params, batch, **kw)
        loss.backward()
        grads = [(pth, t.grad) for pth, t in zip(paths, leaves)]
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    return loss.detach(), grads


def _rel_gap(got, want):
    """max |got - want| / max |want| (float32)."""
    want = want.detach().float().cpu()
    got = got.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _tree_to(tree, dev):
    """A copy of a tree of tensors on ``dev``."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev, copy=True), tree)


def train_reduced_checks(dev, phase):
    """The reduced float32 gemma_2b, qwen3_moe_30b_a3b and mamba2_370m,
    the same parameters and SyntheticLM batch on the card and on the CPU:
    the loss and every gradient leaf within F32_TOL of the leaf's max,
    then the parameters after 3 AdamW steps (``build_train_step``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        check(cfg.dtype == "float32", "reduced config is not float32")
        model = build_model(cfg)
        host = model.init(seed=3, device="cpu")
        card = _tree_to(host, dev)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=2, seed=0))
        b = data.batch_at(0)
        lc, g_card = _grad_leaves(model, card, batch_to(b, dev), remat=True)
        lh, g_host = _grad_leaves(model, host, batch_to(b, "cpu"), remat=True)
        # run to run on the card: the dense and SSM steps reduce in a
        # fixed order; the MoE expert gather's backward (index_select's
        # index_add_) accumulates with atomics
        _, again = _grad_leaves(model, card, batch_to(b, dev), remat=True)
        repeat = _bits_equal([g for _, g in g_card], [g for _, g in again])
        check(repeat or cfg.moe is not None, f"{phase}: reduced {arch}: "
              f"two equal backward passes on the card differ")
        lgap = abs(float(lc) - float(lh)) / abs(float(lh))
        check(lgap <= F32_TOL, f"{phase}: reduced {arch} loss on the card "
              f"{float(lc):.6f} vs the CPU's {float(lh):.6f}")
        worst = max(_rel_gap(a, b2) for (_, a), (_, b2) in zip(g_card, g_host))
        for (pth, a), (_, b2) in zip(g_card, g_host):
            check(_rel_gap(a, b2) <= F32_TOL, f"{phase}: reduced {arch} "
                  f"gradient {pth} differs: {_rel_gap(a, b2):.3e}")
        # 3 steps at the reference's eps 1e-8, held per element: an
        # element whose CPU gradient is at most F32_TOL of its leaf's max
        # at some step (below what the gradient check holds the card's
        # sign to) may move +-lr with either sign, so within 2 lr a step
        # of the CPU's; every other element within F32_TOL of the leaf's
        # max
        ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=3)
        sc, sh = (build_train_step(model, ocfg, device=dev),
                  build_train_step(model, ocfg, device="cpu"))
        oc, oh = OPT.init_state(card), OPT.init_state(host)
        noise = [torch.zeros(t.shape, dtype=torch.bool)
                 for t in tree_leaves(host)]
        for i in range(3):
            _, gs = _grad_leaves(model, host, batch_to(data.batch_at(i),
                                                        "cpu"), remat=True)
            for m, (_, g) in zip(noise, gs):
                m |= g.abs() <= F32_TOL * g.abs().max()
            card, oc, _ = sc(card, oc, data.batch_at(i))
            host, oh, _ = sh(host, oh, data.batch_at(i))
        pworst = nworst = 0.0
        for a, b2, m in zip(tree_leaves(card), tree_leaves(host), noise):
            gap = (a.cpu() - b2).abs()
            if not m.all():
                pworst = max(pworst, float(gap[~m].max())
                             / max(float(b2.abs().max()), 1e-30))
            if m.any():
                nworst = max(nworst, float(gap[m].max()))
        nlimit = 2 * ocfg.lr_peak * 3
        nshare = (sum(int(m.sum()) for m in noise)
                  / sum(m.numel() for m in noise))
        check(pworst <= F32_TOL and nworst <= nlimit, f"{phase}: reduced "
              f"{arch} parameters after 3 AdamW steps differ: {pworst:.3e} "
              f"of a leaf's max (limit {F32_TOL}), {nworst:.3e} where the "
              f"gradient is at noise (limit {nlimit:g})")
        log(f"{phase}: reduced float32 {arch}, card vs CPU: loss "
            f"{float(lc):.6f} (rel gap {lgap:.3e}), {len(g_card)} gradient "
            f"leaves within {F32_TOL} of each leaf's max (worst "
            f"{worst:.3e}); parameters after 3 AdamW steps at eps 1e-8 "
            f"within {pworst:.3e} of a leaf's max, and {nworst:.3e} (limit "
            f"{nlimit:g}) on the {nshare:.4f} of elements whose gradient "
            f"is at noise; a second backward pass on the card "
            f"{'bitwise equal' if repeat else 'NOT bitwise equal'}")


def train_cut_check(dev, phase):
    """gemma-2b's published widths cut to TRAIN_CUT layers in float32,
    B 1, S 64: the card's loss and gradients against the CPU's within
    F32_TOL, and a planted fault (the -1 target mask ignored) outside."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to
    from repro_torch.models.api import build_model
    from repro_torch.models.common import chunked_lm_loss, rmsnorm
    from repro_torch.tree import leaves as tree_leaves

    cfg = dataclasses.replace(full_width_config(), num_layers=TRAIN_CUT,
                              dtype="float32")
    model = build_model(cfg)
    card = model.init(seed=0, device=dev)
    n = sum(t.numel() for t in tree_leaves(card))
    host = _tree_to(card, "cpu")
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                               global_batch=1, seed=0)).batch_at(0)
    b["targets"] = b["targets"].copy()
    b["targets"][:, ::5] = -1                   # masked targets
    t0 = time.perf_counter()
    lc, g_card = _grad_leaves(model, card, batch_to(b, dev), remat=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    lh, g_host = _grad_leaves(model, host, batch_to(b, "cpu"), remat=True)
    t_host = time.perf_counter() - t0
    lgap = abs(float(lc) - float(lh)) / abs(float(lh))
    gaps = {pth: _rel_gap(a, b2) for (pth, a), (_, b2) in zip(g_card, g_host)}
    worst = max(gaps.items(), key=lambda kv: kv[1])
    check(lgap <= F32_TOL and worst[1] <= F32_TOL,
          f"{phase}: full-width {TRAIN_CUT}-layer float32 loss gap "
          f"{lgap:.3e}, worst gradient {worst[0]} {worst[1]:.3e} (limit "
          f"{F32_TOL})")
    # the planted fault: the same loss with the target mask ignored
    with torch.no_grad():
        tok = batch_to(b, dev)
        x, _, _ = model.forward_hidden(card, tok["tokens"])
        xn = rmsnorm(x, card["final_norm"], cfg.norm_eps, gemma_style=True)
        nll, cnt = chunked_lm_loss(xn, card["embed"].T,
                                   tok["targets"].clamp(min=0))
        fault = float(nll / cnt)
    fgap = abs(fault - float(lh)) / abs(float(lh))
    check(fgap > F32_TOL, f"{phase}: the planted fault (mask ignored) lies "
          f"within the limit: {fgap:.3e}")
    log(f"{phase}: full-width gemma-2b cut to {TRAIN_CUT} layers, float32, "
        f"{n} parameters, B 1 S 64 with every 5th target masked: loss "
        f"card {float(lc):.6f} vs CPU {float(lh):.6f} (rel gap {lgap:.3e}), "
        f"{len(gaps)} gradient leaves within {F32_TOL} of each leaf's max "
        f"(worst {worst[0]} {worst[1]:.3e}); planted fault (mask ignored) "
        f"{fault:.6f}, rel gap {fgap:.3e} > {F32_TOL}; loss+backward "
        f"{t_card:.2f} s on the card (first call), {t_host:.2f} s on the "
        f"CPU")
    del card, host, g_card, g_host
    gc.collect()
    torch.cuda.empty_cache()


def train_full_width(ops, dev, phase):
    """Full-width gemma-2b (18 layers, bf16, seed 0) trained by
    ``build_train_step`` with ``remat=True`` at B TRAIN_B, S TRAIN_S on
    one repeated SyntheticLM batch: TRAIN_WARM untimed steps, then
    TRAIN_TIMED timed ones (finite losses, the last below the first);
    the step's wall and device time, idle share, peak memory, the
    forward/backward and AdamW device times, bound and MFU."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    cfg = full_width_config()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    tokens = TRAIN_B * TRAIN_S
    ocfg = OPT.AdamWConfig(lr_peak=1e-4, warmup_steps=2, total_steps=100)
    step = build_train_step(model, ocfg, remat=True, device=dev)
    ost = OPT.init_state(params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_S, global_batch=TRAIN_B,
                                   seed=0)).batch_at(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        t0 = time.perf_counter()
        params, ost, mets = step(params, ost, batch)
        losses.append(float(mets["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    timed = losses[TRAIN_WARM:]
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss {losses}")
    check(timed[-1] < timed[0], f"{phase}: the loss did not fall over the "
          f"timed steps: {timed}")
    check(not any(counts.values()), f"{phase}: the training step launched "
          f"kernels: {counts}")
    wall_med = float(np.median(walls[TRAIN_WARM:])) * 1e3
    dev_ms, ev_wall, _ = trace_ms(lambda: step(params, ost, batch),
                                  iters=3, warmup=0, tries=2)
    # the forward/backward and the AdamW update alone, on this state
    from repro_torch.tree import flatten_with_paths, tree_map

    b = batch_to(batch, dev)
    leaves = flatten_with_paths(params)[1]

    def fwd_bwd(keep=False):
        # the gradients are dropped at the end, as the step drops them:
        # kept into the next call they would crowd its activations
        for t in leaves:
            t.requires_grad_(True)
        model.loss(params, b, remat=True)[0].backward()
        grads = tree_map(lambda t: t.grad, params) if keep else None
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        return grads

    fb_ms, fb_wall, _ = trace_ms(fwd_bwd, iters=3, warmup=1, tries=2)
    log(f"{phase}: the step's largest device-time entries: " + "; ".join(
        f"{name} {ms:.1f} ms x{n}" for name, ms, n in top_kernels(
            lambda: step(params, ost, batch))))
    grads = fwd_bwd(keep=True)
    opt_ms, opt_wall, _ = trace_ms(
        lambda: OPT.apply_updates(ocfg, params, grads, ost), iters=3,
        warmup=1, tries=2)
    del grads

    def split_step():
        """The step's body with CUDA events between its parts: (host ms
        to issue the forward+backward, then its ms on the card's
        timeline, idle gaps included, then AdamW's)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        h0 = time.perf_counter()
        g = fwd_bwd(keep=True)
        h1 = time.perf_counter()
        ev[1].record()
        OPT.apply_updates(ocfg, params, g, ost)
        ev[2].record()
        torch.cuda.synchronize()
        return ((h1 - h0) * 1e3, ev[0].elapsed_time(ev[1]),
                ev[1].elapsed_time(ev[2]))

    split = np.median([split_step() for _ in range(5)], axis=0)
    log(f"{phase}: inside a step (CUDA events between its parts, median "
        f"of 5 steps): forward+backward {split[1]:.1f} ms of the card's "
        f"timeline, issued by the host in {split[0]:.1f} ms; AdamW "
        f"{split[2]:.1f} ms ({CARD})")
    flops_model = 6 * n * tokens
    flops_remat = 8 * n * tokens
    fb_bound = flops_remat / BF16_FLOPS * 1e3
    model_bound = flops_model / BF16_FLOPS * 1e3
    opt_bound = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
    step_s = wall_med / 1e3
    mfu = flops_model / (step_s * BF16_FLOPS)
    log(f"{phase}: full-width gemma-2b training, bf16, {n} parameters, "
        f"remat, B {TRAIN_B} S {TRAIN_S} ({tokens} tokens a step), "
        f"build_train_step: losses {[round(x, 4) for x in losses]} "
        f"({TRAIN_WARM} untimed, then {TRAIN_TIMED} timed), finite and "
        f"falling; no kernel launched ({CARD})")
    log(f"{phase}: step wall median {wall_med:.1f} ms over {TRAIN_TIMED} "
        f"steps (host clock, each ending in the loss's read; range "
        f"{min(walls[TRAIN_WARM:]) * 1e3:.1f}-"
        f"{max(walls[TRAIN_WARM:]) * 1e3:.1f}); traced: device "
        f"{dev_ms:.1f} ms, wall {ev_wall:.1f} ms (CUDA events), idle share "
        f"{1 - dev_ms / ev_wall:.3f}; forward+backward device {fb_ms:.1f} "
        f"ms (wall {fb_wall:.1f}), AdamW device {opt_ms:.1f} ms (wall "
        f"{opt_wall:.1f}): shares {fb_ms / (fb_ms + opt_ms):.3f} / "
        f"{opt_ms / (fb_ms + opt_ms):.3f}; peak memory {peak / 2**30:.2f} "
        f"GiB ({CARD})")
    log(f"{phase}: hardware bound {fb_bound + opt_bound:.1f} ms = "
        f"forward+backward with remat {flops_remat / 1e12:.1f} TFLOP at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s ({fb_bound:.1f} ms, operations) + "
        f"AdamW {ADAMW_BYTES * n / 1e9:.1f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({opt_bound:.1f} ms, bytes); "
        f"step / bound {wall_med / (fb_bound + opt_bound):.2f}, AdamW / its "
        f"bound {opt_ms / opt_bound:.2f}, forward+backward / its bound "
        f"{fb_ms / fb_bound:.2f}; model bound {model_bound + opt_bound:.1f} "
        f"ms (6 N T = {flops_model / 1e12:.1f} TFLOP, {model_bound:.1f} ms, "
        f"+ AdamW), step / model bound "
        f"{wall_med / (model_bound + opt_bound):.2f}; MFU "
        f"{flops_model / 1e12:.1f} TFLOP / "
        f"({step_s:.4f} s x {BF16_FLOPS / 1e12:.0f} TFLOP/s) = {mfu:.3f} "
        f"({CARD})")
    del params, ost, model, leaves, b
    gc.collect()
    torch.cuda.empty_cache()


def top_kernels(fn, k=8):
    """[(kernel name, device ms, calls)] of one traced call of ``fn``,
    the ``k`` largest by device time (names cut to 60 characters)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key[:60], _device_us(e) / 1e3, e.count)
                   for e in prof.key_averages() if _device_us(e) > 0),
                  key=lambda r: -r[1])
    return rows[:k]


def _bits_equal(a, b):
    from repro_torch.tree import leaves as tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def train_resume_check(dev, tmp, phase):
    """Reduced gemma_2b through ``train.loop.run`` on the card, float32
    (SyntheticLM) and bfloat16 (MemmapTokens over a seeded token file,
    its TreeArray index on the card): 8 steps uninterrupted against 4,
    then a resume to 8; parameters and moments bitwise equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.train.loop import TrainLoopConfig, run

    tokens = tmp / "tokens.bin"
    np.random.default_rng(0).integers(0, 512, 40_001).astype(
        np.int32).tofile(tokens)
    for dtype, source in (("float32", "synthetic"), ("bfloat16", "memmap")):
        cfg = dataclasses.replace(get_config("gemma_2b").reduced(),
                                  dtype=dtype)
        model = build_model(cfg)
        ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=2, seed=3, source=source,
                          path=str(tokens))

        def go(name, total):
            params = model.init(seed=0, device=dev)
            lcfg = TrainLoopConfig(total_steps=total, ckpt_every=4,
                                   ckpt_dir=str(tmp / f"{dtype}-{name}"),
                                   log_every=1000)
            return run(build_train_step(model, ocfg, device=dev), params,
                       OPT.init_state(params), dcfg, lcfg, device=dev,
                       log=lambda *_: None)

        full = go("full", 8)
        go("cut", 4)
        resumed = go("cut", 8)
        same = _bits_equal({"p": full["params"], "o": full["opt_state"]},
                           {"p": resumed["params"], "o": resumed["opt_state"]})
        check(same and full["losses"][4:] == resumed["losses"],
              f"{phase}: reduced gemma_2b {dtype}: the resumed run differs "
              f"from the uninterrupted one")
        log(f"{phase}: reduced gemma_2b {dtype} ({source} data) through "
            f"train.loop.run on the card: 8 steps uninterrupted vs 4 + "
            f"resume to 8, parameters and moments bitwise equal (losses "
            f"{[round(x, 4) for x in full['losses']]})")


def train_checkpoint_io(dev, tmp, phase):
    """The full-width TRAIN_CUT-layer cut in bf16 with float32 moments
    after one step, saved from the card and restored onto it, bitwise;
    the write's and the read's GB/s."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.tree import leaves as tree_leaves
    import shutil

    cfg = dataclasses.replace(full_width_config(), num_layers=TRAIN_CUT)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    ost = OPT.init_state(params)
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                               global_batch=1, seed=0)).batch_at(0)
    params, ost, _ = build_train_step(model, OPT.AdamWConfig(),
                                      device=dev)(params, ost, b)
    tree = {"params": params, "opt": ost}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        {"p": params, "m": ost.mu, "v": ost.nu})) + 4
    free = shutil.disk_usage(tmp).free
    check(free > nbytes + (1 << 30), f"{phase}: {free} bytes free on disk "
          f"for a {nbytes}-byte checkpoint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CKPT.save(str(tmp / "ckpt"), 1, tree)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = CKPT.restore(str(tmp / "ckpt"), 1, tree)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    nfiles = len(os.listdir(tmp / "ckpt" / "step_00000001" / "blocks"))
    check(_bits_equal(tree, back), f"{phase}: the restored checkpoint "
          f"differs from the saved state")
    check(all(t.device.type == "cuda" for t in tree_leaves(back)),
          f"{phase}: the restore did not land on the card")
    log(f"{phase}: checkpoint of the full-width {TRAIN_CUT}-layer cut "
        f"(bf16 params + float32 moments, {nbytes} B in {nfiles} blocks of "
        f"<= {CKPT.BLOCK_BYTES} B) saved from the card in {t_save:.2f} s "
        f"({nbytes / t_save / 1e9:.2f} GB/s) and restored onto it in "
        f"{t_load:.2f} s ({nbytes / t_load / 1e9:.2f} GB/s), bitwise equal")
    del params, ost, tree, back
    gc.collect()
    torch.cuda.empty_cache()


def train_path(ops, dev):
    """Phase 14: training on the card."""
    import tempfile

    phase = "phase 14"
    marks = [("start", time.perf_counter())]
    train_reduced_checks(dev, phase)
    marks.append(("reduced", time.perf_counter()))
    train_cut_check(dev, phase)
    marks.append(("float32 cut", time.perf_counter()))
    train_full_width(ops, dev, phase)
    marks.append(("full width", time.perf_counter()))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase14-") as tmp:
        tmp = Path(tmp)
        train_resume_check(dev, tmp, phase)
        marks.append(("resume", time.perf_counter()))
        train_checkpoint_io(dev, tmp, phase)
        marks.append(("checkpoint", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))


# ---------------------------------------------------------------------------
# phase 15: Whisper-tiny and InternVL2-1B at model level
# ---------------------------------------------------------------------------
ENCDEC_PATH = ("paged_attention_append", "paged_prefill_attention")
ENC_B = 4                          # rows of the model-level runs
WHISPER_PROMPTS = (64, 37, 50, 13)  # prompt tokens of each row
WHISPER_STEPS = 64                 # decode steps: rows end by token 128
WHISPER_CTX = 448                  # whisper's published decoder context
VLM_PREFIX = (128, 64, 128, 64)    # text tokens after the 256 image ones
VLM_SUFFIX = (64, 37, 50, 13)      # text tokens of the suffix prefill
VLM_STEPS = 32
CHECK_STEPS = 4                    # bf16 kernel-vs-plain decode steps
REDUCED_SCALE = 8                  # the reduced configs' 8-token blocks
ENC_TRAIN = {"whisper_tiny": (8, 448), "internvl2_1b": (4, 256)}
ENC_TRAIN_WARM, ENC_TRAIN_TIMED = 2, 3


def _rebuild(model, *, dtype=None, plain=False):
    """``model``'s architecture again (its ``max_positions`` too), in
    ``dtype`` or the served one, on the kernel or the plain path."""
    from repro_torch.models.api import build_model

    cfg = model.cfg
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.",
                                                                ""))
    return build_model(cfg, plain=plain,
                       max_positions=getattr(model, "max_positions", 4096))


def _inputs15(model, dev, seed, scale=1):
    """Phase 15's batch for ``model`` (``ENC_B`` rows, lengths divided by
    ``scale``), drawn on the CPU from ``seed`` and moved to ``dev``:
    whisper's frames, prompts of ``WHISPER_PROMPTS`` tokens and empty
    state; InternVL2's image embeddings, a prefix of 256 image tokens and
    ``VLM_PREFIX`` text tokens (both block-aligned), a one-block text
    suffix of ``VLM_SUFFIX`` real tokens and the suffix's write tables.
    Tables come from a ``PagedKVManager`` over room for the decode
    steps."""
    from repro_torch.core.paged_kv import PagedKVManager

    cfg = model.cfg
    B, d, bt = ENC_B, cfg.d_model, cfg.kv_block_tokens
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)

    def cut(ns):
        return [max(1, n // scale) for n in ns]

    def ints(n):
        return torch.randint(2, cfg.vocab_size, (B, n), generator=g)

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32)

    inp = {}
    if cfg.encoder is not None:
        lens = cut(WHISPER_PROMPTS)
        inp["steps"] = WHISPER_STEPS // scale
        S = max(lens)
        inp["frames"] = 0.1 * torch.randn(
            (B, cfg.encoder.num_frames, d), generator=g)
        max_seq = S + inp["steps"]
    else:
        I = cfg.num_image_tokens
        prefix, suffix = cut(VLM_PREFIX), cut(VLM_SUFFIX)
        inp["steps"] = VLM_STEPS // scale
        S = max(prefix)
        lens = [I + n for n in prefix]
        check(all(n % bt == 0 for n in lens) and max(suffix) <= bt,
              "phase 15's InternVL2 prefixes are not block-aligned")
        inp["image_embeds"] = 0.1 * torch.randn((B, I, d), generator=g)
        inp["suffix"] = ints(bt)
        inp["starts"] = i32(lens)
        inp["slens"] = i32([n + s for n, s in zip(lens, suffix)])
        max_seq = I + S + bt + inp["steps"]
    inp["toks"] = ints(S)
    inp["lens"] = i32(lens)
    inp["max_seq"] = max_seq
    mgr = PagedKVManager(model.kv_config(max_seq=max_seq, batch=B))
    inp["tables"] = torch.as_tensor(np.stack([
        (mgr.admit(i, max_seq), mgr.device_table(i))[1] for i in range(B)]))
    if "suffix" in inp:
        blk = inp["starts"].long() // bt
        inp["wt"] = inp["tables"][torch.arange(B), blk][:, None].contiguous()
    inp = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in inp.items()}
    inp["state"] = _state15(model, inp)
    return inp


def _state15(model, inp):
    """An empty decode state of ``model`` (its dtype) over ``inp``'s
    tables."""
    from repro_torch.core.paged_kv import PagedKVCache

    dev = inp["tables"].device
    if model.cfg.encoder is not None:
        st = model.init_state(ENC_B, inp["max_seq"], device=dev)
        st.self_kv.block_tables.copy_(inp["tables"])
        return st
    st = PagedKVCache.create(model.kv_config(max_seq=inp["max_seq"],
                                             batch=ENC_B), ENC_B, device=dev)
    st.block_tables.copy_(inp["tables"])
    return st


def _clone15(state):
    """``state`` with its own copy of the self-attention pools (whisper's
    cross K/V is only read, and stays shared)."""
    from repro_torch.models.whisper import WhisperState

    if isinstance(state, WhisperState):
        return dataclasses.replace(state, self_kv=_clone_pools(state.self_kv))
    return _clone_pools(state)


def _prefill15(model, params, inp, state=None):
    """Whisper's prefill (frames encoded), or InternVL2's prefill of its
    image + text prefix: (last logits, state).  ``state`` defaults to the
    batch's own (its pools are written in place)."""
    state = inp["state"] if state is None else state
    if "frames" in inp:
        return model.prefill(params, inp["toks"], state, inp["lens"],
                             frames=inp["frames"])
    return model.prefill(params, inp["toks"], state, inp["lens"],
                         image_embeds=inp["image_embeds"])


def _suffix15(model, params, inp, state):
    """InternVL2's text suffix through ``prefill_suffix`` (#2)."""
    return model.prefill_suffix(params, inp["suffix"], state, inp["slens"],
                                inp["starts"], inp["wt"])


def _prompt15(model, params, inp, state=None):
    """The whole prompt: ([last logits of each stage], state)."""
    lg, st = _prefill15(model, params, inp, state)
    if "suffix" not in inp:
        return [lg], st
    ls, st = _suffix15(model, params, inp, st)
    return [lg, ls], st


def _greedy15(model, params, state, nxt, steps):
    """``steps`` greedy decode steps: ([logits], [tokens fed], state)."""
    logits, fed = [], []
    for _ in range(steps):
        fed.append(nxt)
        lg, state = model.decode_step(params, nxt, state)
        logits.append(lg)
        nxt = lg.argmax(-1)
    return logits, fed, state


def _wall_median(fn, n=5, warmup=1):
    """Median wall ms of ``n`` calls of ``fn``, each ended by a sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _timed15(phase, name, what, fn):
    """Log ``fn``'s median wall, its traced device time (one trace: a
    model-level call's trace is never clean, see ``trace_ms``) and the
    idle share."""
    wall = _wall_median(fn)
    dev_ms, _ = time_ms(fn, iters=5, warmup=1, tries=1)
    log(f"{phase}: {name} {what}: wall median {wall:.3f} ms (5 calls, "
        f"each ended by a sync), device {dev_ms:.3f} ms per call (trace), "
        f"idle share {1 - dev_ms / wall:.3f} ({CARD})")


def encdec_served(ops, ref, model, params, dev, phase):
    """The model-level run at full width: the prompt (InternVL2: prefix,
    then the text suffix through #2) and greedy decode steps through #1,
    with the launch counters zeroed just before and read just after and
    each kernel's heaviest call recorded; then #1 (and #2) at that call
    against its plain version beside SDPA and its bound, and the
    encode, prefill, suffix and decode-step times and the loop's
    tokens/s."""
    cfg, L = model.cfg, model.cfg.num_layers
    inp = _inputs15(model, dev, seed=0)
    steps = inp["steps"]
    rec = Recorder(ops, ENCDEC_PATH)
    rec.install()
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        stage, st = _prompt15(model, params, inp)
        logits, fed, st = _greedy15(model, params, st, stage[-1].argmax(-1),
                                    steps)
        torch.cuda.synchronize()
        counts = {k: ops.launch_counts()[k] for k in ENCDEC_PATH}
    finally:
        rec.remove()
    for lg in stage + logits:
        check(lg.shape == (ENC_B, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"{phase}: {cfg.name} logits not finite or misshapen")
    want = {"paged_attention_append": L * steps,
            "paged_prefill_attention": L if "suffix" in inp else 0}
    log(f"{phase}: {cfg.name}: kernel launches on the model-level path "
        f"(prompt + {steps} decode steps, counts zeroed just before) "
        f"{json.dumps(counts)}; expected {json.dumps(want)}")
    check(counts == want, f"{phase}: {cfg.name} did not launch #1 once per "
          f"layer per decode step (and #2 once per layer of the suffix)")
    if cfg.encoder is not None:
        check(int(st.self_kv.seq_lens.max()) <= WHISPER_CTX,
              f"{phase}: a row ran past whisper's 448-token context")
    measure_append(ops, ref, rec.last, counts, phase)
    if "suffix" in inp:
        measure_prefill(ops, ref, rec.last, counts, phase)
    del rec
    # times (kernel path, the served bfloat16)
    if cfg.encoder is not None:
        _timed15(phase, cfg.name, f"encode ({ENC_B} x "
                 f"{cfg.encoder.num_frames} frames)",
                 lambda: model.encode(params, inp["frames"]))
    extra = " + the image" if "suffix" in inp else ", encode included"
    _timed15(phase, cfg.name, f"prefill ({ENC_B} x {inp['toks'].shape[1]} "
             f"tokens{extra})", lambda: _prefill15(model, params, inp))
    if "suffix" in inp:
        _, pre = _prefill15(model, params, inp)
        _timed15(phase, cfg.name, f"prefill_suffix ({ENC_B} x "
                 f"{inp['suffix'].shape[1]} text tokens, #2)",
                 lambda: _suffix15(model, params, inp, pre))
    _, st0 = _prompt15(model, params, inp)
    nxt = stage[-1].argmax(-1)
    _timed15(phase, cfg.name, f"decode step ({ENC_B} rows)",
             lambda: model.decode_step(params, nxt, st0))
    _, st0 = _prompt15(model, params, inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _greedy15(model, params, st0, nxt, steps)
    torch.cuda.synchronize()
    loop = time.perf_counter() - t0
    log(f"{phase}: {cfg.name} model-level greedy loop: {steps} decode steps "
        f"x {ENC_B} rows in {loop * 1e3:.1f} ms: "
        f"{ENC_B * steps / loop:.1f} tokens/s ({CARD})")
    return inp, stage, logits, fed


def encdec_paths_agree(model, params, inp, stage, logits, fed, phase):
    """Kernel path against plain path: in bfloat16 the prompt's stages
    and ``CHECK_STEPS`` decode steps (fed the kernel path's tokens)
    within LOGIT_TOL of max |logit|; in float32 (all layers) the suffix
    (#2) and one decode step within F32_LOGIT_TOL, which the plain path
    with the new token left out must exceed."""
    cfg = model.cfg
    plain = _rebuild(model, plain=True)
    pstage, pst = _prompt15(plain, params, inp, _clone15(inp["state"]))
    worst = max(_rel_gap(a, b) for a, b in zip(stage, pstage))
    for i in range(CHECK_STEPS):
        lp, pst = plain.decode_step(params, fed[i], pst)
        worst = max(worst, _rel_gap(logits[i], lp))
    log(f"{phase}: full-width {cfg.name} bfloat16, kernel vs plain path: "
        f"{worst:.4e} of max |logit| over the prompt's {len(stage)} "
        f"stage(s) and {CHECK_STEPS} decode steps (tol {LOGIT_TOL})")
    check(worst <= LOGIT_TOL, f"{phase}: {cfg.name} kernel-path logits "
          f"differ from the plain path")
    del pst
    f32 = torch.float32
    from repro_torch.tree import tree_map
    p32 = tree_map(lambda x: x.to(f32), params)
    k32, pl32 = _rebuild(model, dtype=f32), _rebuild(model, dtype=f32,
                                                     plain=True)
    faulty = _rebuild(model, dtype=f32, plain=True)
    faulty.kernels = SelfLeftOut
    inp32 = dict(inp, state=_state15(k32, inp))
    lg, st = _prefill15(k32, p32, inp32)
    gaps = []
    if "suffix" in inp:
        ls, stk = _suffix15(k32, p32, inp32, _clone15(st))
        lsp, _ = _suffix15(pl32, p32, inp32, _clone15(st))
        gaps.append(("prefill_suffix", _rel_gap(ls, lsp)))
        st, lg = stk, ls
    nxt = lg.argmax(-1)
    a, _ = k32.decode_step(p32, nxt, _clone15(st))
    b, _ = pl32.decode_step(p32, nxt, _clone15(st))
    f, _ = faulty.decode_step(p32, nxt, _clone15(st))
    gaps.append(("decode step", _rel_gap(a, b)))
    fault = _rel_gap(f, b)
    log(f"{phase}: full-width {cfg.name} in float32, kernel vs plain path: "
        + ", ".join(f"{n} {g:.4e}" for n, g in gaps)
        + f" of max |logit| (tol {F32_LOGIT_TOL}); control, plain path "
        f"with the new token left out: {fault:.4e} (must exceed the tol)")
    check(all(g <= F32_LOGIT_TOL for _, g in gaps), f"{phase}: float32 "
          f"{cfg.name} kernel-path logits differ from the plain path")
    check(fault > F32_LOGIT_TOL, f"{phase}: the planted fault stays within "
          f"the float32 logits limit")
    del p32, st, inp32
    torch.cuda.empty_cache()


def encdec_reduced_check(dev, arch, phase):
    """``arch.reduced()`` in float32 on the card against the CPU, with
    the same seed-3 weights and inputs: the prompt's stages and greedy
    decode steps within F32_TOL, identical tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    cfg = get_config(arch).reduced()
    check(cfg.dtype == "float32", "reduced config is not float32")
    model = build_model(cfg, max_positions=64)
    host = model.init(seed=3, device="cpu")
    out = {}
    for d, p in (("cpu", host), ("cuda", _tree_to(host, dev))):
        inp = _inputs15(model, torch.device(d) if d == "cpu" else dev, 6,
                        REDUCED_SCALE)
        stage, st = _prompt15(model, p, inp)
        logits, fed, _ = _greedy15(model, p, st, stage[-1].argmax(-1),
                                   inp["steps"])
        out[d] = (stage + logits, fed)
    worst = 0.0
    for a, b in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        worst = max(worst, assert_close(f"reduced {arch} card vs CPU",
                                        a.cpu(), b, F32_TOL))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(out["cuda"][1],
                                                       out["cpu"][1]))
    log(f"{phase}: reduced float32 {arch} on the card vs the CPU: logits "
        f"within {F32_TOL} over the prompt and {len(out['cpu'][1])} "
        f"greedy decode steps (max |diff| {worst:.3e}), tokens "
        f"{'identical' if same else 'DIFFERENT'}")
    check(same, f"{phase}: reduced {arch} greedy tokens differ between the "
          f"card and the CPU")


def encdec_train(ops, model, params, dev, phase):
    """One full-width bf16 ``build_train_step(remat=True)`` on one seeded
    batch (whisper B 8, S 448 with 1500 frames; InternVL2 B 4, 256 image
    + 256 text): ENC_TRAIN_WARM untimed and ENC_TRAIN_TIMED timed steps,
    finite and falling losses, no kernel launched; the step's wall and
    device time, idle share, peak memory and MFU (6 N T at the bf16
    peak)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    cfg = model.cfg
    arch = "whisper_tiny" if cfg.encoder is not None else "internvl2_1b"
    B, S = ENC_TRAIN[arch]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    n = sum(t.numel() for t in tree_leaves(params))
    if cfg.encoder is not None:
        F = cfg.encoder.num_frames
        batch["frames"] = (0.1 * rng.normal(size=(B, F, cfg.d_model))
                           ).astype(np.float32)
        n_enc = sum(t.numel() for t in tree_leaves(params["enc_layers"]))
        flops = 6 * (n_enc * B * F + (n - n_enc) * B * S)
        what = (f"B {B}, S {S}, {F} frames: 6 x ({n_enc} encoder parameters "
                f"x {B * F} frames + {n - n_enc} others x {B * S} tokens)")
    else:
        I = cfg.num_image_tokens
        batch["image_embeds"] = (0.1 * rng.normal(size=(B, I, cfg.d_model))
                                 ).astype(np.float32)
        flops = 6 * n * B * (I + S)
        what = f"B {B}, {I} image + {S} text tokens: 6 x {n} x {B * (I + S)}"
    ocfg = OPT.AdamWConfig(lr_peak=1e-4, warmup_steps=2, total_steps=100)
    step = build_train_step(model, ocfg, remat=True, device=dev)
    ost = OPT.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for _ in range(ENC_TRAIN_WARM + ENC_TRAIN_TIMED):
        t0 = time.perf_counter()
        params, ost, mets = step(params, ost, batch)
        losses.append(float(mets["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    timed = losses[ENC_TRAIN_WARM:]
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss {losses}")
    check(timed[-1] < timed[0], f"{phase}: {cfg.name} loss did not fall "
          f"over the timed steps: {timed}")
    check(not any(counts.values()), f"{phase}: the training step launched "
          f"kernels: {counts}")
    wall = float(np.median(walls[ENC_TRAIN_WARM:])) * 1e3
    dev_ms, ev_wall, _ = trace_ms(lambda: step(params, ost, batch),
                                  iters=2, warmup=0, tries=1)
    mfu = flops / (wall / 1e3 * BF16_FLOPS)
    log(f"{phase}: full-width {cfg.name} training, bf16, {n} parameters, "
        f"remat, {what} = {flops / 1e12:.3f} TFLOP a step: losses "
        f"{[round(x, 4) for x in losses]} ({ENC_TRAIN_WARM} untimed, then "
        f"{ENC_TRAIN_TIMED} timed), finite and falling; no kernel launched; "
        f"step wall median {wall:.1f} ms (host clock); traced device "
        f"{dev_ms:.1f} ms, wall {ev_wall:.1f} ms (CUDA events), idle share "
        f"{1 - dev_ms / ev_wall:.3f}; peak memory {peak / 2**30:.2f} GiB; "
        f"MFU {mfu:.4f} at {BF16_FLOPS / 1e12:.0f} TFLOP/s ({CARD})")
    del ost, step
    return params


def encdec_path(ops, ref, dev):
    """Phase 15: Whisper-tiny and InternVL2-1B at published widths."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.tree import leaves as tree_leaves

    phase = "phase 15"
    marks = [("start", time.perf_counter())]
    for arch in ("whisper_tiny", "internvl2_1b"):
        cfg = get_config(arch)
        model = build_model(cfg, max_positions=WHISPER_CTX)
        params = model.init(seed=0, device=dev)
        n = sum(t.numel() for t in tree_leaves(params))
        log(f"{phase}: {cfg.name}, {n} parameters ({n * 2 / 1e9:.3f} GB in "
            f"bf16), {cfg.num_layers} decoder layers, d {cfg.d_model}, "
            f"{cfg.num_heads} heads over {cfg.kv_heads} KV heads of "
            f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
        inp, stage, logits, fed = encdec_served(ops, ref, model, params,
                                                dev, phase)
        marks.append((f"{arch} served", time.perf_counter()))
        encdec_paths_agree(model, params, inp, stage, logits, fed, phase)
        del inp, stage, logits, fed
        marks.append(("paths", time.perf_counter()))
        encdec_reduced_check(dev, arch, phase)
        marks.append(("reduced", time.perf_counter()))
        encdec_train(ops, model, params, dev, phase)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(("training", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))


# ---------------------------------------------------------------------------
# phase 16: the paper's serving benchmarks
# ---------------------------------------------------------------------------
#: phase 16's full-width bench.serve: phase 3's engine (4 slots, 384
#: tokens a row, watermark 0) over its pool of 768 tokens, in 8-token
#: blocks -- the bench caps prompts at min(24, max_seq // 2) tokens and a
#: fork needs one whole block in common, so at gemma-2b's 64-token blocks
#: no request could fork and the bench's prefix gate could not hold
SERVE_FULL_ARGV = ("--arch", "gemma_2b", "--no-reduced", "--slots", "4",
                   "--max-seq", "384", "--num-blocks", "96", "--watermark",
                   "0", "--trace", "prefixheavy")
SERVE_FULL_BLOCK = 8


def bench_path(ops, dev, model, params):
    """Phase 16: ``repro_torch.bench.end2end`` (Fig. 5) at full width on
    phase 3's weights and in its reduced float32 row, then
    ``repro_torch.bench.serve --smoke`` (reduced) and the full-width
    ``bench.serve`` on phase 3's weights; every gate of both benches
    holds, and #1 launched."""
    import tempfile

    from repro_torch.bench import end2end
    from repro_torch.bench import serve as bserve
    from repro_torch.models.api import build_model

    phase = "phase 16"
    t0 = time.perf_counter()
    models = {"full": (model, params),
              "reduced": end2end.row_model("reduced", dev)}
    ops.reset_launch_counts()
    rows = end2end.run(device=dev, models=models)
    counts = ops.launch_counts()
    check(counts["paged_attention_append"] > 0,
          f"{phase}: end2end launched no paged_attention_append")
    for r in rows:
        if r["name"].startswith("fault"):
            log(f"{phase}: end2end {r['row']}: planted fault (the "
                f"{r['layout']} table permuted, no data moved): gap "
                f"{r['gap']:.4e} against tol {r['tol']} -> "
                f"{'trips' if r['trips'] else 'passes'} the gate")
            continue
        log(f"{phase}: end2end {r['row']} {r['name']} (B {r['B']}, ctx "
            f"{r['ctx']}, {r['block_tokens']}-token blocks): replayed step "
            f"wall {r['us'] / 1e3:.4f} ms (median of 10), device "
            f"{r['device_ms']:.4f} ms, #1 {r['attn_ms']:.4f} ms per step "
            f"(bound {r['bound_ms']:.5f} ms, {r['bound_by']}); over the "
            f"contiguous step: wall {r['step_x_contiguous']:.4f}, #1 "
            f"{r['attn_x_contiguous']:.4f}; logits gap to contiguous "
            f"{r['gap']:.4e} (tol {r['tol']})")
    log(f"{phase}: end2end launches {json.dumps(counts)}")
    for label, (m, p) in models.items():
        _, B, max_seq, ctx = end2end.ROWS[label]
        _, cache = end2end.layouts(m, B, max_seq, ctx, dev)[-1]
        step = end2end.ReplayedStep(m, p, end2end.step_tokens(m.cfg, B, dev),
                                    cache)
        log(f"{phase}: end2end {label} contiguous step, largest kernels "
            f"(name, device ms, calls): {top_kernels(step, 6)}")
        del step, cache
    log(f"{phase}: end2end {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    cfg8 = dataclasses.replace(model.cfg, kv_block_tokens=SERVE_FULL_BLOCK)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase16-") as tmp:
        for what, argv, models in (
                ("reduced --smoke", ("--smoke",), {}),
                (f"full width, {SERVE_FULL_BLOCK}-token blocks",
                 SERVE_FULL_ARGV,
                 {("gemma_2b", False, 384, 0):
                  (cfg8, build_model(cfg8), params)})):
            ops.reset_launch_counts()
            ts = time.perf_counter()
            try:
                rep = bserve.main(list(argv) + ["--device", "cuda"],
                                  models=models, out_dir=tmp)
            except SystemExit as e:
                raise SmokeFailure(f"{phase}: bench.serve {what} failed a "
                                   f"gate ({e})") from None
            counts = ops.launch_counts()
            check(rep["all_ok"], f"{phase}: bench.serve {what}: all_ok "
                  f"false")
            for name in ("paged_attention_append", "gather_blocks",
                         "scatter_blocks"):
                check(counts[name] > 0, f"{phase}: bench.serve {what} "
                      f"launched no {name}")
            log(f"{phase}: bench.serve {what}: all_ok true in "
                f"{time.perf_counter() - ts:.1f} s; tokens/s "
                f"{rep['tokens_per_s']} (scripted), "
                f"{rep.get('trace_tokens_per_s')} ({rep['arrival_trace']['kind']} "
                f"trace); swap out/in {rep['swap_out_bytes']}/"
                f"{rep['swap_in_bytes']} B ({rep['blocks_swapped_out']} "
                f"blocks of {rep['swap_nbytes_per_block']} B), "
                f"{rep['swap_bytes_per_step']} B/step; prefix hits "
                f"{rep['prefix_hits']} (rate {rep['prefix_share_hit_rate']}),"
                f" prefill tokens saved {rep['prefill_tokens_saved']}; "
                f"prefetches {rep['prefetches']}, hits "
                f"{rep['prefetch_hits']}, rate {rep['prefetch_hit_rate']}"
                + (f"; probe prefetch hits "
                   f"{rep['prefetch_probe']['prefetch_hits']}, suffix "
                   f"identical {rep['suffix_prefill_probe']['token_identical']}"
                   f", decode path ok {rep['decode_path']['ok']}, mixed arch "
                   f"ok {rep['mixed_arch']['ok']}, migrate ok "
                   f"{rep['migrate']['ok']}" if "migrate" in rep else "")
                + f"; launches {json.dumps(counts)}")
    log(f"{phase}: bench.serve {time.perf_counter() - t1:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build_all()
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"phase 1: built {sorted(build.SOURCES)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: no output"
    log(card)
    global CARD
    CARD = card

    small_checks(ops, ref, dev)
    block_edge_checks(ops, ref, dev)
    split_edge_checks(ops, ref, dev)
    large_block_checks(ops, ref, dev)
    attention_edge_checks(ops, ref, dev)
    tree_small_checks(ops, ref, dev)
    mark("phases 1-2", t_start)
    model, params, eng, counts, last = serve_full_width(
        dev, ops, full_width_config())
    rows = measure(ops, ref, last, counts)
    del eng
    logits_check(model, params, dev, "paged_attention_append", "phase 5")
    reduced_checks(dev, "gemma_2b", "phase 5")
    mark("phases 3-5", t_start)
    # the serving benchmarks run on phase 3's weights, which leave after
    bench_path(ops, dev, model, params)
    mark("phase 16", t_start)
    del params
    torch.cuda.empty_cache()
    mla_model, mla_params, mla_counts, mla_last = serve_paged(
        dev, ops, mla_config(), "phase 6", MLA_PATH, MLA_TRACE_SEED)
    rows += measure_mla(ops, ref, mla_last, mla_counts)
    logits_check(mla_model, mla_params, dev, "paged_attention", "phase 6",
                 seeds=F32_SEEDS)
    del mla_params
    torch.cuda.empty_cache()
    reduced_checks(dev, "minicpm3_4b", "phase 6")
    del mla_model
    mark("phase 6", t_start)
    tree_counts = tree_path(ops)
    rows += measure_tree(ops, ref, tree_counts)
    mark("phase 7", t_start)
    # Qwen3 takes the GQA path's kernels, DeepSeek-V2-Lite the MLA path's
    moe_path(dev, ops, ref, "qwen3_moe_30b_a3b", qwen3_config(), "phase 8",
             MAIN_PATH, QWEN_TRACE_SEED)
    mark("phase 8", t_start)
    moe_path(dev, ops, ref, "deepseek_v2_lite_16b", deepseek_config(),
             "phase 9", MLA_PATH, DS_TRACE_SEED)
    mark("phase 9", t_start)
    # the constant-state paths; #6's row comes from Mamba2's served
    # state-pool compaction
    rows.append(state_path(dev, ops, ref, "mamba2_370m", "phase 10"))
    mark("phase 10", t_start)
    state_path(dev, ops, ref, "zamba2_2p7b", "phase 11")
    mark("phase 11", t_start)
    state_path(dev, ops, ref, "rwkv6_7b", "phase 12")
    mark("phase 12", t_start)
    migration_path(dev, ops, ref)
    mark("phase 13", t_start)
    train_path(ops, dev)
    mark("phase 14", t_start)
    encdec_path(ops, ref, dev)
    mark("phase 15", t_start)
    order = {name: i for i, name in enumerate(TABLE_ORDER)}
    rows.sort(key=lambda r: order[r["name"]])
    check([r["name"] for r in rows] == list(TABLE_ORDER),
          "the kernels line does not hold every ported kernel once")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
