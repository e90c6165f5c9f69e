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
   engine on both paths, which must decode identical tokens.  Then one
   prefill bucket of each kind through a strategy of phase 3's geometry
   over poisoned pools (``prefill_replay_check``): a ``(4, 192)``
   prefill and a ``(1, 64)`` suffix prefill over a 128-token shared
   prefix (#2 inside), eager at the first sighting, captured and
   replayed at the second: last logits and every block the call's
   tables name bitwise equal, no other block than the sink touched by
   the eager call, the warm-ups, the capture or the replay; a replay
   whose token upload is skipped (the planted fault) must give other
   logits, a correct replay of the new tokens the eager call's bits;
   each bucket's device part timed eager and replayed (wall and device
   time) beside the whole strategy call; phase 6 (MiniCPM3-4B) holds a
   ``(1, 192)`` prefill the same way, and phase 8 (Qwen3-30B-A3B)
   within ``MOE_GAP_FACTOR`` x two eager calls' gap, without the fault;
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
   step's over 2 decode setups (``F32_SEEDS``), and
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
    sink, no recapture on the decode engine, the worker's prefill
    buckets captured at their second sighting, none recaptured; the
    source and the moved engine's buckets likewise, then the moved
    engine's pools rebound through its executor and the trace served
    again: each bucket it had captured and reaches again captured once
    more, one recapture), Mamba2-370M migrated as
    gemma-2b on phase 10's settings (its tail: every running row's whole
    state block), and #4 and #5 at the phase's heaviest calls against
    their plain versions, bit for bit;
14. training, whose one kernel is ``adamw_update`` (one pass over a
    leaf; the reference's update is jnp, no ``pallas_call``): the
    reduced float32 gemma_2b, qwen3_moe_30b_a3b and mamba2_370m on the
    card against the CPU (the loss and every gradient leaf within
    ``F32_TOL`` of the leaf's max, then the parameters after 3 AdamW
    steps); 14b, every family of ``TRAIN_GRAPH_ARCHS`` reduced in
    float32, ``GRAPH_STEPS`` eager steps against the captured step (2
    eager warm-up steps, the capture, a replay) from one state, bitwise
    for the dense and state families and within ``MOE_GAP_FACTOR`` x
    two eager runs' gap for MoE, the capture and a replay of two of them
    under ``set_sync_debug_mode("error")``; 14c, a replay whose batch
    copy is left out fails that check; gemma-2b's published widths cut
    to ``TRAIN_CUT`` layers in float32 at B 1, S 64, card against CPU
    within ``F32_TOL``, with a planted fault (the -1 target mask
    ignored) outside it; 14d, full-width gemma-2b in bf16 (2.506 B
    parameters, seed 0, ``remat=True``, B ``TRAIN_B``, S ``TRAIN_S``)
    trained by ``build_train_step`` captured into one CUDA graph:
    ``TRAIN_WARM`` eager warm-up steps, one eager control step, the
    capture and ``TRAIN_TIMED`` timed replays on one batch with finite,
    falling losses and ``adamw_update`` launched once a leaf a step and
    nothing else; the captured and the eager step's wall and device
    time, idle share, MFU (6 N T over the step at the bf16 peak) and
    peak memory, the capture's time and pool, the eager forward/backward
    and AdamW device times, the largest kernels and the bound (remat's 8
    N T operations at the bf16 peak plus AdamW's 22 bytes a parameter at
    HBM's rate); 14a, ``adamw_update`` over every leaf against its plain
    version on copies (m and v within 1 float32 ulp, p within 1 bf16
    ulp), the whole update's time beside the plain loop's, its bound and
    ``torch._fused_adamw_`` where it takes the leaves; 14e, reduced
    gemma_2b through ``train.loop.run`` with the captured step in
    float32 (``SyntheticLM``) and bf16 (``MemmapTokens``, its TreeArray
    index on the card), 8 steps against 4 + resume to 8, bitwise; and
    the ``TRAIN_CUT``-layer cut's bf16 parameters and float32 moments
    (7.44 GB) saved from the card and restored onto it bitwise, with the
    write's and the read's GB/s (files in a ``.phase14-*`` temporary
    directory of the checkout); the phase's time split;
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
    tokens), captured, finite and falling losses, ``adamw_update`` the
    only kernel launched, the step's wall and device time, idle share,
    peak memory and MFU;
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
    (``large_block_checks``);
17. the data axis of the mesh (``repro_torch.launch.mesh``, ``steps``,
    ``train.compressed``), right after phase 16 on phase 3's weights: a
    1 x 1 NCCL mesh built from a ``HashStore`` (no
    ``init_process_group``) whose prefill and serve steps (#1) equal
    ``prefill``/``decode_step`` bit for bit at B 8 (the serve step's wall
    and device time beside the one-device one's), and whose train step,
    with and without ZeRO-1, equals ``build_train_step`` bit for bit on
    phase 14's two-layer full-width float32 cut (untimed); then two gloo
    thread ranks
    sharing the card: the full-width serve step over ``dp_groups=2``
    pools on shared read-only weights (gathered logits within
    LOGIT_TOL of the one-device step, equal greedy tokens, #1 counted on
    each rank), reduced float32 gemma-2b within 1e-5 of max|logit| with
    a planted table fault outside, and on reduced float32 gemma-2b the
    data-parallel step within 1e-5 of the global step, ZeRO-1 equal to
    it bit for bit and the int8 error-feedback step within the
    reference's 2e-3 of the exact update (nonzero residual), with the
    bytes each sync handed in and the bytes staged through pinned host
    memory;
18. the model axis of the mesh (Megatron tensor and expert parallelism
    in the serve and prefill steps) on two gloo thread ranks sharing
    the card: 18a, right after phase 17 on phase 3's weights,
    full-width gemma-2b bf16 at tp 2 (4 query heads a rank over the one
    KV head) against the one-device prefill and decode steps within
    TP_LOGIT_TOL with equal greedy tokens, #1 counted on each rank and
    held against its plain version at G 4, the TP step's wall and
    device time beside the one-device step's with its collectives a
    step, and reduced float32 gemma-2b within 1e-5 with a planted fault
    (the ranks' ``wo`` pieces swapped) outside; 18b, inside phase 8: the
    bf16 ``tp`` steps on the first ``TP_SERVED_DEPTH`` layers of the
    served Qwen3-30B-A3B weights within LOGIT_TOL, then on its 4-layer
    float32 cut the ``tp`` steps within 1e-5
    of the dropless one-device steps, one MoE layer's ``ep`` exchange
    within 1e-5 of ``moe_ep_local`` with the dropped replicas counted,
    and the layer's all-to-all bytes against ``tp``'s all-reduce; 18c,
    inside phase 9 on DeepSeek-V2-Lite's 4-layer float32 cut, MLA heads
    split (#7 at G 8 on each rank, held against its plain version),
    shared experts and the leading dense layer within 1e-5.  Each part
    logs a ``done at`` mark;
19. training over the model axis, right after phase 14, with ranks as
    processes sharing the card over gloo (this process's cached memory
    freed first): 19a, ``torchrun --standalone --nproc_per_node 2 -m
    repro_torch.launch.train --arch gemma_2b --model-parallel 2
    --device cuda:0`` at full width in bf16 with phase 14's seed, data,
    B and S (remat, sequence parallelism), ``TP_TRAIN_STEPS`` steps: the
    first step's loss and clip norm within 2e-2 (the norm's times
    max(1, norm)) of phase 14's first one-device step, each step's wall,
    each rank's collectives, staged bytes and peak memory; 19b, one
    ``spawn_ranks`` call on (1, 2): phase 14's two-layer full-width
    float32 cut at tp 2 with sequence parallelism on and off, the loss
    and clip norm within 1e-5 relative of the one-device step and every
    leaf after one AdamW step within 1e-5 of its max, and a planted fault
    (one column-parallel input's backward sum left out) outside; 19c, a
    second call: Qwen3-30B-A3B's published widths cut to
    ``TP_QWEN_CUT`` layers in float32, ``tp`` and ``ep`` (nothing
    dropped), the same gates;
20. the constant-state families over the model axis (their SSM heads
    split, the norms over every head summed over the ranks, Mamba2's
    packed ``in_proj`` as each rank's pieces): 20a, inside phase 11 on
    its served weights, Zamba2-2.7B bf16 on its first
    ``TP_STATE_DEPTH`` layers (two groups, views) at tp 2 on two gloo
    thread ranks sharing the card, prefill and ``MESH_STEPS`` decode
    steps against the one-device steps within TP_LOGIT_TOL, and no more
    than TP_STATE_EXCESS farther from the same layers' float32 one-device
    steps than the one-device bf16 steps are, greedy tokens equal except
    at near ties (18b's rule, the margin also within TP_LOGIT_TOL), #1
    counted on each rank (once per group a step) and held against its
    plain version at the rank's KVH 16, G 1, HD 80; then the same layers
    in float32 within F32_LOGIT_TOL with a planted fault (the norms'
    model-axis sum of squares left out) outside; 20b, inside phase 12, the same for RWKV6-7B, which
    launches no kernel, held to the TP_STATE_EXCESS reading alone (its
    recurrence compounds bf16 rounding flips past TP_LOGIT_TOL); 20c, in
    phase 19's ``spawn_ranks`` call: Mamba2-370M, RWKV6-7B and
    Zamba2-2.7B (two groups, two LoRAs) at published widths cut to
    ``TP_STATE_F32`` layers in float32, tp 2 with sequence parallelism,
    19b's gates, Mamba2's planted norm fault outside.  Each part logs a
    ``done at`` mark;
21. Whisper-tiny and InternVL2-1B over the model axis: 21a and 21b,
    inside phase 15 on its bf16 weights before its training step, a
    prefill of phase 15's rows (1500 stub frames; 256 image tokens and
    ``VLM_PREFIX``) and ``MESH_STEPS`` decode steps at tp 2 on two gloo
    thread ranks sharing the card against the one-device steps within
    TP_LOGIT_TOL, greedy tokens equal except at near ties, #1 counted on
    each rank (16 and 96) and held against its plain version at the
    rank's KVH 3, G 1 and KVH 1, G 7 (HD 64), each rank's collectives
    and staged bytes; then the same in float32 within F32_LOGIT_TOL, a
    planted fault outside (the cross attention's ``wo`` left unsummed;
    the ranks' attention ``wo`` rows swapped); 21c, in phase 19's
    ``spawn_ranks`` call: float32 train steps at published widths with
    sequence parallelism (Whisper-tiny whole, InternVL2-1B on
    ``TP_VLM_CUT`` layers), the loss and clip norm within
    TP_ENC_LOSS_TOL relative of one device, every leaf within 1e-5 of
    its max, a planted fault outside (the cross attention's ``wo``
    unsummed; the image-prefixed piece without its gather).  The served
    phases' resident tails (6, 8-12) trace the replayed tail alone; phase
    3 reads the replayed and the eager tail and a capture;
22. the cost account (``repro_torch.cost``): 22a, after phase 5 on phase
    3's weights, one eager ``decode_step`` of full-width gemma-2b (B
    ``ACCT_B``, contexts of ``ACCT_LENS`` tokens, #1 inside) recorded on
    the card and again on meta tensors (``param_specs``,
    ``decode_state_specs``) at the same shapes: the two accounts equal
    (FLOPs, bytes, every category and kernel line), the bill's bound
    (bytes over 3.35 TB/s, FLOPs over the bf16 peak) at most the step's
    device time (torch.profiler), the peak tracker's rise beside
    ``max_memory_allocated``'s (printed); 22b, inside phase 14 on 14d's
    model, one eager train step (``graph=False``) recorded the same way,
    the same gates, the tracker's rise within ``ACCT_PEAK_TOL`` of
    ``max_memory_allocated``'s, and its FLOPs over the 6 N T that MFU
    uses; 22c, ``dryrun.run_cell("gemma_2b", "decode_32k")`` on the 16 x
    16 placeholder mesh, in this process (no card), its row printed;
    22d, the cost-model bench's cases on the card
    (``bench/cost_model.py``): every predicted:analytic ratio within
    [0.5, 4.0], each case's device time beside its bill's bound.

On every served path (phases 3, 6 and 8-12) the recorded run takes the
eager decode tail and, on the paged paths (3, 6, 8, 9), the eager
prefill (``graphs=False``), the timed runs replay the decode graphs
(one captured CUDA graph per update width) and the prefill buckets (one per ``(B, S)``, captured at its second
sighting: each timed run must capture every bucket it sees twice or
more once, none it sees once, recapture nothing and replay each
captured bucket at every later sighting; logged with its capture
seconds, the shared graph pool's bytes and the prefill wall beside the
eager control's), and, in
phases 3 and 10-12, one more timed run on the eager tail is the control
(phases 6, 8 and 9 read the recorded run as the eager one): the first
graph run must
give the recorded run's tokens for every request, preemptions, swap
bytes and table-sync rows and bytes after every step, saved prefill
tokens and kernel launches, and every graph run must capture each width
it reaches once, recapture nothing and replay every decode step; both
tokens/s medians are logged.  Then the engine's resident tail
(``strategy.decode_resident``) is timed in the steady state, replayed
(wall, device time, idle share); in phase 3 also eager,
beside one capture's wall and device time and the graph pool's bytes.

Phases 15, 17, 19, 20c and 21c launch ``adamw_update`` in their train
steps, and 20a's, 21a's and 21b's #1 launches are held outside the
kernels line, which holds the ten ported kernels' rows and
``adamw_update``'s, its launches from phase 14d.  Prints a ``{"kernels": [...]}``
line, then as its last line
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
# the kernels' bills: one formula for a row's bound and the cost account
from repro_torch.cost import kernels as KBILL  # noqa: E402
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
SERVE_RUNS = 3                     # timed full-width serve runs
#: traces of one whole eager step (or every layer's MoE feed-forward):
#: never clean (see ``trace_ms``), so the most complete of this many is used
STEP_TRIES = 1
#: calls of one whole eager decode step timed, after two warm-up calls
#: (a host-bound eager step of the deep paths takes 0.1-0.25 s a call)
STEP_CALLS = 10
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
F32_SEEDS = tuple(range(5, 7))
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
    # no Pallas counterpart: the reference's update is jnp that XLA fuses
    "adamw_update": "none (no pallas_call; XLA fuses the jnp update at "
                    "src/repro/optim/adamw.py:75)",
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
    "adamw_update": "src/repro_torch/kernels/csrc/adamw.cu",
}
MAIN_PATH = ("paged_attention_append", "paged_prefill_attention",
             "copy_pool_blocks", "gather_blocks", "scatter_blocks")
MLA_PATH = ("paged_attention", "copy_pool_blocks", "gather_blocks",
            "scatter_blocks")
TREE_PATH = ("tree_gather", "tree_block_sum", "tree_gather_rows")
TRAIN_PATH = ("adamw_update",)
#: the kernels line, in the order of PERF.md's kernel table
TABLE_ORDER = ("paged_attention_append", "paged_prefill_attention",
               "copy_pool_blocks", "gather_blocks", "scatter_blocks",
               "block_copy", "paged_attention") + TREE_PATH + TRAIN_PATH
#: peak device memory of phase 7 (a 4 GB array, its 4 GB pool and a
#: 4 GB gather, with the comparisons' temporaries in 512 MB pieces)
TREE_PEAK_BYTES = 20 << 30
ACCT_B = 4                         # rows of 22a's recorded decode step
ACCT_LENS = (190, 200, 205, 210)   # their cached tokens
ACCT_PEAK_TOL = 0.10               # 22b: tracker rise vs the allocator's


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
    ("gemma-2b, tp 2", 1, 4, 256, 6, None, (None, 100, 128)),
    ("gemma-2b, tp 2", 1, 4, 256, 64, None, (None, 100, 128)),
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
    (64-token blocks): gemma-2b's (1 kv head, G 8, head_dim 256, and
    G 4: a rank's heads over a model axis of 2),
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
    (G 16 over a 576-wide latent, V its first 512), each also at the
    half of its heads a rank holds over a model axis of 2 (G 20, G 8),
    float32 and bfloat16,
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
                 (1, 40, 288, 256, True), (1, 16, 576, 512, True),
                 (1, 20, 288, 256, True), (1, 8, 576, 512, True)),
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
        f"({n} cases: G 1, 4, and 40, 20, 16 and 8 with MLA latent V of "
        f"256 and 512, 6- and 64-block "
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
            "graphs": st["decode_graphs"], "prefill": st["prefill_graphs"],
            "prefill_s": st["phase_time_s"]["prefill"]}


def _prefill_buckets_ok(name, pg, phase):
    """A run's prefill buckets (``Engine.stats["prefill_graphs"]``): each
    run eagerly at its first sighting; each seen twice or more captured
    once, at its second sighting, and replayed at every sighting from
    then on (the capturing call replays too); none seen once captured;
    no recapture.  Returns the buckets as "name seen/captured/replayed"."""
    for k, b in pg.get("buckets", {}).items():
        n = b["sightings"]
        check(pg["graphs"] and b["eager"] == 1 and b["captures"] == (n >= 2)
              and b["replays"] == n - 1,
              f"{phase}: {name}: prefill bucket {k} {b}")
    check(pg.get("recaptures", 0) == 0, f"{phase}: {name}: prefill graphs "
          f"recaptured {pg.get('recaptures')} times")
    return ", ".join(f"{k} {b['sightings']}/{b['captures']}/{b['replays']}"
                     for k, b in pg.get("buckets", {}).items())


def prefill_graphs_check(phase, eager, runs, control, control_name):
    """The prefill buckets of every timed run ``runs`` against the eager
    recorded run ``eager``: the same buckets seen as often; each bucket
    seen twice or more captured once, at its second sighting (one eager
    run before it), and replayed at every sighting from then on (the
    capturing call replays too); a bucket seen once never captured; no
    recapture.  Logs each run's buckets, capture seconds, the shared
    graph pool's bytes and the prefill seconds against the eager control
    run's."""
    want = {k: b["sightings"] for k, b in eager["prefill"]["buckets"].items()}
    check(not eager["prefill"]["graphs"] and not control["prefill"]["graphs"]
          and all(b["captures"] == 0
                  for b in eager["prefill"]["buckets"].values()),
          f"{phase}: the eager runs captured prefill graphs")
    for i, r in enumerate(runs):
        pg = r["prefill"]
        seen = {k: b["sightings"] for k, b in pg["buckets"].items()}
        check(pg["graphs"] and seen == want,
              f"{phase}: run {i}: prefill buckets {seen} against the eager "
              f"run's {want}")
        buckets = _prefill_buckets_ok(f"run {i}", pg, phase)
        log(f"{phase}: run {i}: prefill buckets (seen/captured/replayed: "
            f"{buckets}); captures "
            f"{pg['capture_s']:.4f} s, prefill graphs' pool bytes "
            f"{pg['pool_bytes']}, shared graph pool {pg['shared_pool_bytes']}"
            f" B (decode graphs {r['graphs']['pool_bytes']} B); prefill "
            f"wall {r['prefill_s']:.4f} s (captures included) against "
            f"{control['prefill_s']:.4f} s eager ({control_name}); {CARD}")


def graphs_vs_eager(phase, eager, runs, control, kernels,
                    control_name="the control"):
    """The replayed decode and prefill graphs against the eager tail and
    prefill on one path: the first timed run (graphs) must give the
    recorded run's (eager) tokens for every request, preemptions, swap
    bytes and table-sync rows and bytes after every step, prefill tokens
    saved, steps, decode steps and kernel launches (those of ``kernels``
    logged, #2 among them on a GQA path); every graph run must have
    captured each decode bucket it reached once, recaptured nothing and
    replayed every decode step, and on a paged path its prefill buckets
    must pass ``prefill_graphs_check``.  Logs both tokens/s medians: the
    timed graph runs and the eager run ``control`` (``control_name``)."""
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
    if eager["prefill"]:              # a paged path: prefill buckets
        prefill_graphs_check(phase, eager, runs, control, control_name)
    launched = ", ".join(f"{k} {g['counts'][k]} times" for k in kernels)
    log(f"{phase}: replayed graphs (run 0) vs eager tail (the recorded "
        f"run): identical tokens for {len(g['tokens'])} requests, "
        f"preemptions {g['preemptions']}, prefill tokens saved {g['saved']}, "
        f"swap bytes and table-sync rows/bytes equal after each of "
        f"{len(g['ledger'])} steps (at the end {g['ledger'][-1]}), the same "
        f"kernel launches" + (f" ({launched})" if kernels else ""))
    rates = [r["rate"] for r in runs]
    net = [r["toks"] / (r["dt"] - r["graphs"]["capture_s"]
                        - r["prefill"].get("capture_s", 0.0)) for r in runs]
    log(f"{phase}: tok/s median, replayed graphs "
        f"{float(np.median(rates)):.2f} ({len(runs)} runs, min "
        f"{min(rates):.2f}, max {max(rates):.2f}; "
        f"{float(np.median(net)):.2f} without each run's decode and prefill "
        f"capture seconds), "
        f"eager tail {control['rate']:.2f} (1 run, {control_name}); "
        f"{CARD}")


def tail_step(model, params, dev, phase, full=False):
    """The engine's resident decode tail (``strategy.decode_resident``) on
    3 live sequences in the steady state (update width 0), replayed from
    its captured graph: wall ms per call (CUDA events around each call,
    the card idle before it; median of TAIL_CALLS), device ms per call
    (torch.profiler over TAIL_CALLS calls) and the idle share.  With
    ``full`` (phase 3) the tail also runs eagerly on an engine of its
    own, and one capture's wall time (host clock, synchronised) and
    device time (torch.profiler: the warm-ups' work) and the graph
    pool's bytes are read.  Each sequence first holds
    blocks for TAIL_ROOM more tokens, so that every timed call appends
    into its own blocks.  Logs its own seconds."""
    from repro_torch.serve.engine import Engine, Request

    t_start = time.perf_counter()
    out = {}
    for graphs in (True, False) if full else (True,):
        eng = Engine(model, params, slots=4, max_seq=384, num_blocks=16,
                     eos_id=-1, watermark=0, prefill_budget=None,
                     graphs=graphs, device=dev)
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
        if graphs and full:
            strat.release_graphs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            cap_wall = time.perf_counter() - t0
            pool = strat.graph_stats["pool_bytes"]
            strat.release_graphs()
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
    secs = time.perf_counter() - t_start
    gw, gd, gl = out[True]
    if not full:
        log(f"{phase}: resident decode tail, 3 rows, steady state (width "
            f"0): replayed graph {gw:.3f} ms wall (median of {TAIL_CALLS} "
            f"calls; {gl:.3f} back to back), {gd:.3f} ms device, idle "
            f"share {1 - gd / gw:.3f}; {CARD}; tail_step "
            f"{secs:.1f} s")
        return
    ew, ed, el = out[False]
    log(f"{phase}: resident decode tail, 3 rows, steady state (width 0): "
        f"replayed graph {gw:.3f} ms wall (median of {TAIL_CALLS} calls; "
        f"{gl:.3f} back to back), {gd:.3f} ms device, idle share "
        f"{1 - gd / gw:.3f}; eager tail {ew:.3f} ms wall ({el:.3f} back to "
        f"back), {ed:.3f} ms device, idle share {1 - ed / ew:.3f}; replay "
        f"{ew / gw:.2f}x faster; one capture (width 0: the tail twice on a "
        f"side stream, then the capture) {cap_wall * 1e3:.1f} ms wall, "
        f"{cap_dev:.3f} ms device, graph pool {pool} B; {CARD}; tail_step "
        f"{secs:.1f} s")


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
                      graphs=graphs, device=dev)

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
    log(f"phase 3: recorded run (eager tail and prefill): heaviest call per "
        f"kernel "
        f"{json.dumps(rec.work)}")
    runs = []
    for i in range(SERVE_RUNS + 1):
        graphs = i < SERVE_RUNS
        eng, toks, dt, counts, st, forced, r = run(graphs=graphs)
        log(f"phase 3: run {i if graphs else 'control'}: served 12 "
            f"requests, {toks} tokens in {dt:.4f} s = {toks / dt:.2f} tok/s "
            f"over {eng.steps} steps (slots 4, 12 blocks of 64 tokens, "
            f"prefixheavy trace; decode tail and prefill "
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
    tail_step(model, params, dev, "phase 3", full=True)
    return model, params, rec_eng, counts, rec.last


# ---------------------------------------------------------------------------
# phase 4: main-path shapes, compare and time
# ---------------------------------------------------------------------------
def kernel_row(phase, name, launches, err, k, p, bill, dtype, lib, what=""):
    """Log one kernel's reading and return its entry of the kernels
    line: ``k``, ``p`` and ``lib`` are (device ms, wall ms) per call of
    the kernel, its plain version and the library call (or None);
    ``bill`` is the call's ``cost.kernels`` bill, whose bytes and FLOPs
    give the bound, as the cost account bills the launch."""
    nbytes, flops = int(bill.bytes), int(bill.flops)
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
    bill = KBILL.paged_attention_append(B, KVH, G, HD, VD, MB, BT,
                                        kp.element_size(), keys=keys)
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
                      counts["paged_attention_append"], err, ms, pms, bill,
                      kp.dtype, lib,
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
    bill = KBILL.paged_prefill_attention(
        B, SQ, KVH, G, HD, VD, MB, BT, kp.element_size(),
        kv_keys=int(kl.long().sum()), pairs=int(valid.sum()))
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
                      counts["paged_prefill_attention"], err, ms, pms, bill,
                      kp.dtype, lib,
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
    bill = KBILL.paged_attention_append(B, KVH, G, HD, HD, MB, BT,
                                        kp.element_size())
    b_ms, by = bound(bill.bytes, bill.flops, dtype)
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
    bill = KBILL.paged_attention(B, KVH, G, HD, VD, MB, BT,
                                 pool.element_size(), o.element_size(),
                                 shared_kv=True, self_term=True,
                                 keys=int(lens.sum()) * KVH)
    b_ms, by = bound(bill.bytes, bill.flops, dtype)
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

    def row(name, k, p, bill, dtype, lib, what):
        rows.append(kernel_row(phase, name, counts[name], 0.0, k, p, bill,
                               dtype, lib, what))

    (pool, src, dst), _ = last["copy_pool_blocks"]
    src, dst = np.asarray(src), np.asarray(dst)
    a, b = pool.clone(), pool.clone()
    ops.copy_pool_blocks(a, src, dst)
    ref.copy_pool_blocks_ref(b, torch.from_numpy(src), torch.from_numpy(dst))
    check(torch.equal(a, b), f"{phase}: copy_pool_blocks differs from its "
          f"plain version")
    blk = pool[0, 0].numel() * pool.element_size()
    mv = KBILL.block_move("copy", len(src), pool.shape[0], blk)
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
    mv = KBILL.block_move("gather", len(idx), pool.shape[0],
                          pool[0, 0].numel() * pool.element_size())
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
    mv = KBILL.block_move("scatter", len(idx), pool.shape[0],
                          pool[0, 0].numel() * pool.element_size())
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
        nbytes = int(KBILL.block_move("copy", n, L, blk).bytes)
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
    dev_ms, wall_ms = time_ms(lambda: model.decode_step(params, nxt, cache),
                              iters=STEP_CALLS, warmup=2, tries=STEP_TRIES)
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
# phases 5, 6 and 8: one prefill bucket, replayed against eager
# ---------------------------------------------------------------------------
#: calls per timed reading of a prefill bucket: a 62-layer eager prefill
#: costs the host ~0.2 s a call, and a profiler trace of its ~15,000
#: launches a call ~4 s, so only phase 5 traces (``profile``)
PREFILL_CALLS = 5
#: prompt tokens of the suffix bucket's shared prefix (phase 5)
SUFFIX_PREFIX = 128


def _bucket_setup(strat, model, params, kind, B, S, rng):
    """Requests admitted on ``strat`` for one ``kind`` bucket of (B, S):
    B prompts, the longest S tokens; or (``"suffix"``, B 1) a parent of
    ``SUFFIX_PREFIX`` tokens, prefilled, and a child forked from it at
    its whole prompt with S - 24 tokens more.  Returns (the call, a
    function that draws new tokens of the same bucket, the pool blocks
    the call writes)."""
    from repro_torch.serve.scheduler import Request

    V = model.cfg.vocab_size
    bt = strat.block_tokens
    if kind == "prefill":
        reqs = [Request(rid=i, prompt=rng.integers(2, V, S - 7 * i),
                        max_new=1) for i in range(B)]
        for r in reqs:
            strat.admit(r.rid, len(r.prompt), "default")
        batch = [(i, r, 0) for i, r in enumerate(reqs)]

        def renew():
            for r in reqs:
                r.prompt = rng.integers(2, V, len(r.prompt))
        written = {int(b) for r in reqs
                   for b in strat.mgr.device_table(r.rid) if b >= 0}
        return (lambda: strat.prefill(params, batch)[0]), renew, written
    check(B == 1, "the suffix check takes one row")
    parent = Request(rid=0, prompt=rng.integers(2, V, SUFFIX_PREFIX),
                     max_new=1)
    strat.admit(0, SUFFIX_PREFIX, "default")
    strat.prefill(params, [(0, parent, 0)])
    child = Request(rid=1, max_new=1, prompt=np.concatenate(
        [parent.prompt, rng.integers(2, V, S - 24)]))
    strat.fork(0, 1, SUFFIX_PREFIX, "default")
    strat.extend(1, len(child.prompt))
    batch = [(1, child, SUFFIX_PREFIX)]

    def renew():
        child.prompt = np.concatenate([parent.prompt,
                                       rng.integers(2, V, S - 24)])
    written = {int(b) for b in
               strat.mgr.device_table(1)[SUFFIX_PREFIX // bt:] if b >= 0}
    return (lambda: strat.prefill_suffix(params, batch)[0]), renew, written


def prefill_replay_check(model, params, dev, phase, kind, B, S, *,
                         fault=False, moe=False, profile=False):
    """One ``kind`` prefill bucket of (B, S) through a strategy of the
    served engines' geometry (slots B, max_seq 384) over poisoned pools:
    the first call runs eagerly, the second captures and replays, each
    from the same pools.  The replay must give the eager call's last
    logits and every block the call's tables name bitwise (``moe``:
    within MOE_GAP_FACTOR x the gap between two eager calls, measured
    here), and no other block than the sink may change in either.  With
    ``fault`` new tokens of the bucket go through a replay whose token
    upload is skipped, whose logits must differ from an eager call's on
    the new tokens, and a correct replay of them must equal that call
    bitwise.  Logs the eager body and the replay: wall per call (CUDA
    events over ``PREFILL_CALLS`` calls) and, with ``profile``, device
    time (torch.profiler), and the whole strategy call (host arrays,
    upload, the device part, the argmax's host copy) replayed and
    eager."""
    from repro_torch.mem import Arena
    from repro_torch.serve import prefill_graph as PGM
    from repro_torch.serve.arch import build_strategy

    t_start = time.perf_counter()
    strat = build_strategy(model, arena=Arena(), slots=B, max_seq=384,
                           num_blocks=B * 6 + 4, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    for p in strat._pools():
        p.copy_(torch.randn(p.shape, generator=g, device=dev, dtype=p.dtype))
    call, renew, written = _bucket_setup(strat, model, params, kind, B, S,
                                         np.random.default_rng(31))
    key = (kind, B, S)
    nb = strat._pools()[0].shape[1]
    named = sorted(written)
    others = [b for b in range(nb) if b not in written and b != strat.sink]
    torch.cuda.synchronize()
    p0 = [p.clone() for p in strat._pools()]

    def restore():
        for p, q in zip(strat._pools(), p0):
            p.copy_(q)

    def untouched():
        return all(torch.equal(p[:, others], q[:, others])
                   for p, q in zip(strat._pools(), p0))

    def named_blocks():
        return [p[:, named].clone() for p in strat._pools()]

    call()
    pg = strat._prefill_graphs
    l_eager, b_eager = pg.last.clone(), named_blocks()
    check(pg.eager.get(key) == 1 and key not in pg._set,
          f"{phase}: {kind} {B}x{S}: the first sighting did not run "
          f"eagerly: {pg.stats}")
    check(untouched(), f"{phase}: {kind} {B}x{S}: the eager call wrote a "
          f"block outside its tables")
    if moe:
        restore()
        _, l_again = strat._prefill_body(params, kind, pg._inputs[key])
        b_again = named_blocks()
        ref_gap = max([_rel_gap(l_again, l_eager)]
                      + [_rel_gap(a, b) for a, b in zip(b_again, b_eager)])
        limit = max(MOE_GAP_FACTOR * ref_gap, MOE_GAP_FLOOR)
        del l_again, b_again
    restore()
    call()
    l_graph, b_graph = pg.last.clone(), named_blocks()
    st = pg.stats["buckets"][PGM.bucket_name(key)]
    check(st == {"sightings": 2, "captures": 1, "replays": 1, "eager": 1},
          f"{phase}: {kind} {B}x{S}: the second sighting: {st}")
    check(untouched(), f"{phase}: {kind} {B}x{S}: the warm-ups, capture or "
          f"replay wrote a block outside the call's tables (sink "
          f"{strat.sink} aside)")
    if moe:
        gap = max([_rel_gap(l_graph, l_eager)]
                  + [_rel_gap(a, b) for a, b in zip(b_graph, b_eager)])
        check(gap <= limit, f"{phase}: {kind} {B}x{S}: the replay lies "
              f"{gap:.3e} from the eager call, over {limit:.3e} "
              f"(MOE_GAP_FACTOR x two eager calls' {ref_gap:.3e})")
        held = (f"within {limit:.3e} of the eager call (gap {gap:.3e}; two "
                f"eager calls {ref_gap:.3e})")
    else:
        check(torch.equal(l_graph, l_eager)
              and all(torch.equal(a, b) for a, b in zip(b_graph, b_eager)),
              f"{phase}: {kind} {B}x{S}: the replay's logits or written "
              f"blocks differ from the eager call's")
        held = "bitwise equal to the eager call"
    what = ""
    if fault:
        renew()
        restore()
        plain = PGM.upload
        PGM.upload = lambda arrays, bufs, device: plain(arrays[1:], bufs[1:],
                                                        device)
        try:
            call()
        finally:
            PGM.upload = plain
        l_fault = pg.last.clone()
        restore()
        call()
        l_new = pg.last.clone()
        restore()
        _, l_want = strat._prefill_body(params, kind, pg._inputs[key])
        check(torch.equal(l_new, l_want), f"{phase}: {kind} {B}x{S}: a "
              f"replay of new tokens differs from the eager call on them")
        check(not torch.equal(l_fault, l_want),
              f"{phase}: {kind} {B}x{S}: the planted fault (a replay "
              f"without its token upload) gives the right logits")
        what = (f"; planted fault (token upload skipped before a replay): "
                f"logits {_rel_gap(l_fault, l_want):.3e} from the eager "
                f"call's, caught; a correct replay of the new tokens "
                f"bitwise equal to it")
        del l_fault, l_new, l_want
    bufs = pg._inputs[key]

    def eager_body():
        strat._prefill_body(params, kind, bufs)

    def replay():
        pg._set.replay(key)

    def wall_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(PREFILL_CALLS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / PREFILL_CALLS
    if profile:
        e_dev, e_wall = time_ms(eager_body, iters=PREFILL_CALLS, warmup=1,
                                tries=1)
        g_dev, g_wall = time_ms(replay, iters=PREFILL_CALLS, warmup=1,
                                tries=1)
        timed = (f"device part eager {e_wall:.3f} ms wall, {e_dev:.3f} ms "
                 f"device, replayed {g_wall:.3f} ms wall, {g_dev:.3f} ms "
                 f"device")
    else:
        timed = (f"device part eager {wall_ms(eager_body):.3f} ms wall, "
                 f"replayed {wall_ms(replay):.3f} ms wall")

    def call_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PREFILL_CALLS):
            call()
        return (time.perf_counter() - t0) / PREFILL_CALLS * 1e3
    g_call = call_ms()
    pg.graphs = False
    e_call = call_ms()
    pg.graphs = True
    cap_s, pool = pg.stats["capture_s"], pg.stats["pool_bytes"]
    strat.release_graphs()
    del strat, pg, bufs, p0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: prefill graph, bucket {kind} {B}x{S}"
        + (f" over a {SUFFIX_PREFIX}-token shared prefix (#2 inside)"
           if kind == "suffix" else "")
        + f": the replay's last logits and {len(named)} written blocks "
        f"{held}; no block outside the call's tables touched by the eager "
        f"call, the warm-up, the capture or the replay" + what
        + f"; {timed} (per call, {PREFILL_CALLS} back to back); whole "
        f"strategy call (host arrays, "
        f"upload, argmax to the host) eager {e_call:.3f} ms, replayed "
        f"{g_call:.3f} ms; capture {cap_s:.3f} s, graph pool {pool} B; "
        f"{CARD}; {time.perf_counter() - t_start:.1f} s")


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
    recorded run on the eager tail (the eager reading too), then
    ``MLA_RUNS`` timed runs on the replayed decode graphs, the
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
                     graphs=graphs, device=dev)
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
    log(f"{phase}: recorded run (eager tail and prefill): heaviest call per "
        f"kernel {json.dumps(rec.work)}")
    runs = []
    # no eager control run here: the recorded run is the eager reading
    # (its recorder's clones slow it), the time going to phase 20
    for i in range(MLA_RUNS):
        eng, toks, dt, counts, st, nsteps, r = run()
        log(f"{phase}: run {i}: served 12 requests, {toks} tokens in "
            f"{dt:.4f} s = {toks / dt:.2f} tok/s over {eng.steps} steps "
            f"({nsteps} decode steps; slots 4, 12 blocks of 64 tokens, "
            f"prefixheavy trace of seed {trace_seed}; decode tail and "
            f"prefill replayed graphs); phase split (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
        if i == 0:
            first = (counts, st, nsteps, eng.mgr.config)
        runs.append(r)
        del eng
    counts, st, nsteps, kv = first
    graphs_vs_eager(phase, eager, runs, eager, (decode,),
                    control_name="the recorded run, its recorder on")
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
        KBILL.block_move("copy", len(src), 1, blk), flat.dtype, lib,
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
    # V is the first VD lanes of the same latent rows: read once; the
    # self term's float32 score and value are read once too
    bill = KBILL.paged_attention(B, KVH, G, HD, VD, MB, BT,
                                 pool.element_size(), o.element_size(),
                                 shared_kv=True, self_term=True, keys=keys)
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
        bill, pool.dtype, lib,
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

    dev_ms, wall_ms = time_ms(step, iters=10, warmup=2, tries=STEP_TRIES)
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
        prefill_replay_check(model, params, dev, phase, "prefill", 1, 192,
                             moe=True)
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
    # phase 18b / 18c: the model axis -- 18b's bf16 reading on the served
    # weights, then the float32 cut, the served weights freed first
    t0 = time.perf_counter()
    if not mla:
        tp_moe_served(model, params, dev)
    m32, p32 = _cut(model, params, F32_DEPTH, torch.float32)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    if mla:
        tp_mla(ops, ref, dev, m32, p32)
    else:
        tp_moe(ops, dev, m32, p32)
    part = "phase 18c" if mla else "phase 18b"
    log(f"{part}: {time.perf_counter() - t0:.1f} s")
    mark_part(part)
    del m32, p32
    gc.collect()
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
STATE_RUNS = 1                     # timed serve runs of each state path
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
                     graphs=graphs, device=dev)
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
        KBILL.block_move("copy", len(src), 1, blk), pool.dtype, lib,
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
    (``graphs=False``; a capture, which fails on any host sync, is
    the replayed graphs' stronger check) under
    ``set_sync_debug_mode("error")``: once with every slot re-spliced
    (the row indices uploaded from pinned memory) and once in the steady
    state, on an engine serving 3 sequences for 3 steps first."""
    from repro_torch.serve.engine import Engine, Request

    eng = Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                 eos_id=-1, watermark=0, prefill_budget=None,
                 graphs=False, device=dev)
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
    dev_ms, wall_ms = time_ms(lambda: model.decode_step(params, nxt, st),
                              iters=STEP_CALLS, warmup=2, tries=STEP_TRIES)
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
    part = {"zamba2_2p7b": "phase 20a", "rwkv6_7b": "phase 20b"}.get(arch)
    if part is not None:
        tp_state_served(ops, ref, dev, model, params, part)
        marks.append(("model axis", time.perf_counter()))
        mark_part(part)
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
        KBILL.tree_gather(nl, leaf, es), leaves.dtype,
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
        KBILL.tree_block_sum(nl, leaf, es), torch.float32, None,
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
        KBILL.tree_gather_rows(n, W, got.element_size()), got.dtype, None,
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


def rebind_recaptures(eng, trace, phase):
    """The moved engine's pools rebound through its transfer-plane
    executor (as the transfer plane may rebind them), then ``trace``'s
    requests served again under new ids, their arrivals shifted to now:
    each prefill bucket the engine had captured and reaches again is
    captured once more at its first sighting after the rebind, a bucket
    it had not captured is captured at its second sighting in all, and
    the prefill graphs count one recapture.  Returns the log's text."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.traffic import RequestSource

    t0 = time.perf_counter()
    strat = eng.strategy
    before = strat.graph_stats["prefill"]["buckets"]
    strat._set_streams([p.clone() for p in strat._streams()])
    gc.collect()
    torch.cuda.empty_cache()
    now = eng.steps
    eng.serve(RequestSource([
        Request(rid=1000 + r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                tenant=r.tenant, arrival_time=r.arrival_time + now)
        for r in trace()._trace]), max_steps=100_000)
    eng.arena.assert_quiescent()
    pg = strat.graph_stats["prefill"]
    again = []
    for k, b in pg["buckets"].items():
        w = before.get(k, {"sightings": 0, "captures": 0})
        new = b["sightings"] - w["sightings"]
        if w["captures"] and new:
            again.append(k)
            want = w["captures"] + 1
        elif w["captures"]:
            want = w["captures"]
        else:
            want = int(b["sightings"] >= 2)
        check(b["captures"] == want, f"{phase}: after the rebind, prefill "
              f"bucket {k} {b} (before {w}), want {want} captures")
    check(again and pg["recaptures"] == 1,
          f"{phase}: after the rebind: buckets reached again {again}, "
          f"{pg['recaptures']} recaptures")
    return (f"its pools then rebound and the trace served again: "
            f"{len(again)} captured buckets reached again ({', '.join(again)})"
            f", each captured once more, 1 recapture "
            f"({time.perf_counter() - t0:.1f} s)")


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
    src_prefill = (_prefill_buckets_ok("the source engine",
                                       src.strategy.graph_stats["prefill"],
                                       phase)
                   if kv_check else "")
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
    prefill_note = ""
    if kv_check:
        prefill_note = (
            f"; prefill buckets (seen/captured/replayed) on the source "
            f"{src_prefill}, on the moved engine "
            + _prefill_buckets_ok("the moved engine", gs["prefill"], phase)
            + ", " + rebind_recaptures(dst, trace, phase))
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
        f"destination {gs.get('recaptures', 0)}{prefill_note}; {CARD}")
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
    worker = _prefill_buckets_ok(
        "the prefill worker",
        pre.engine.strategy.graph_stats["prefill"], phase)
    check(pre.engine.strategy.graph_stats["prefill"]["graphs"]
          and not gs["prefill"], f"{phase}: the prefill worker's prefill "
          f"graphs are off, or the decode engine prefilled")
    check(all(r.t_first >= 0 for r in dis.done), f"{phase}: no TTFT stamp")
    dec.arena.assert_quiescent()
    log(f"{phase}: disaggregated prefill of {len(base)} requests (handed off "
        f"at decode steps {steps_at}): tokens identical to the monolithic "
        f"engine, {dis.handoffs} handoffs of {blocks} blocks = "
        f"{dis.handoff_bytes} B ({GEMMA_BLOCK_BYTES} B per block), the "
        f"worker's pool back to its sink, launches "
        + ", ".join(f"{k} {counts[k]}" for k in MIGRATION_PATH)
        + f", decode graphs captured {sorted(gs['captures'])} with "
        f"{gs['recaptures']} recaptures, the worker's prefill buckets "
        f"(seen/captured/replayed) {worker} with no recapture; served in "
        f"{dt:.3f} s; {CARD}")
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
#: 14b: the families of tests/test_torch_train_loss.py's ARCHS, reduced
TRAIN_GRAPH_ARCHS = ("gemma_2b", "gemma3_27b", "minicpm3_4b",
                     "qwen3_moe_30b_a3b", "deepseek_v2_lite_16b",
                     "mamba2_370m", "rwkv6_7b", "zamba2_2p7b",
                     "internvl2_1b", "whisper_tiny")
GRAPH_STEPS = 4                    # eager steps, and warm-up + capture + replays
#: 14b's MoE limit: a run-to-run gap of the atomics' sums is a sample,
#: so a sound replay may exceed one sample; the floor keeps two eager
#: runs that happen to agree from demanding bits.  A skipped batch moves
#: the moments by O(1) of their max.
MOE_GAP_FACTOR = 4.0
MOE_GAP_FLOOR = 1e-6
GRAPH_FAULT_ARCHS = ("gemma_2b", "qwen3_moe_30b_a3b")
GRAPH_SYNC_ARCHS = ("gemma_2b", "qwen3_moe_30b_a3b")
#: (loss, clip norm) of phase 14's first full-width step: phase 19a's
#: one-device reading
TRAIN_FIRST = None


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


def _split_parts(model, params, ost, ocfg, b):
    """(fwd_bwd, split_step) over the full-width state: the forward and
    backward pass alone (the gradients dropped unless kept, as the step
    drops them: kept into the next call they would crowd its
    activations), and one step's body with CUDA events between its
    parts."""
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import flatten_with_paths, tree_map

    leaves = flatten_with_paths(params)[1]

    def fwd_bwd(keep=False):
        for t in leaves:
            t.requires_grad_(True)
        model.loss(params, b, remat=True)[0].backward()
        grads = tree_map(lambda t: t.grad, params) if keep else None
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        return grads

    def split_step():
        """(host ms to issue the forward+backward, then its ms on the
        card's timeline, idle gaps included, then AdamW's)."""
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

    return fwd_bwd, split_step


def train_full_width(ops, ref, dev, phase):
    """14d: full-width gemma-2b (18 layers, bf16, seed 0) trained by
    ``build_train_step`` with ``remat=True`` at B TRAIN_B, S TRAIN_S on
    one repeated SyntheticLM batch, the step captured into one CUDA
    graph: its TRAIN_WARM eager warm-up steps, one eager control step
    (``graph=False``), the capture (which replays once), then
    TRAIN_TIMED timed replays (finite losses, the last below the
    first); ``adamw_update`` the only kernel, one launch a leaf a step;
    the captured and the eager step's wall and device time, idle share,
    MFU and peak memory, the capture's time and pool; then, eagerly, the
    forward/backward and AdamW device times, the bound, and 14a
    (``adamw_alone``).  Returns ``adamw_update``'s row of the kernels
    line."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    cfg = full_width_config()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    n_leaves = len(tree_leaves(params))
    tokens = TRAIN_B * TRAIN_S
    ocfg = OPT.AdamWConfig(lr_peak=1e-4, warmup_steps=2, total_steps=100)
    step = build_train_step(model, ocfg, remat=True, device=dev)
    eager = build_train_step(model, ocfg, remat=True, device=dev,
                             graph=False)
    ost = OPT.init_state(params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_S, global_batch=TRAIN_B,
                                   seed=0)).batch_at(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses = []
    state = [params, ost]

    def one(fn):
        t0 = time.perf_counter()
        state[0], state[1], mets = fn(state[0], state[1], batch)
        losses.append(float(mets["loss"]))
        return time.perf_counter() - t0, mets

    global TRAIN_FIRST
    for i in range(TRAIN_WARM):            # the graph's eager warm-up
        _, mets = one(step)
        if i == 0:
            TRAIN_FIRST = (losses[0], float(mets["grad_norm"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_wall = one(eager)[0] * 1e3       # the eager control step
    eager_peak = torch.cuda.max_memory_allocated()
    eager_res = torch.cuda.max_memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    capture_wall = one(step)[0] * 1e3      # capture, then one replay
    walls = [one(step)[0] * 1e3 for _ in range(TRAIN_TIMED)]
    peak = torch.cuda.max_memory_allocated()
    peak_res = torch.cuda.max_memory_reserved()
    counts = ops.launch_counts()
    st = step.stats()
    total = TRAIN_WARM + 2 + TRAIN_TIMED
    timed = losses[-TRAIN_TIMED:]
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss {losses}")
    check(timed[-1] < timed[0], f"{phase}: the loss did not fall over the "
          f"timed steps: {timed}")
    check((st["eager_steps"], st["captures"], st["recaptures"],
           st["replays"]) == (TRAIN_WARM, 1, 0, TRAIN_TIMED + 1),
          f"{phase}: the captured step's stats {st}")
    check(counts["adamw_update"] == n_leaves * total
          and not any(v for k, v in counts.items() if k != "adamw_update"),
          f"{phase}: {total} training steps launched {counts}, want "
          f"adamw_update {n_leaves} a step and nothing else")
    params, ost = state
    wall_med = float(np.median(walls))
    dev_ms, ev_wall, _ = trace_ms(lambda: step(params, ost, batch),
                                  iters=3, warmup=0, tries=2)
    e_dev, e_ev_wall, _ = trace_ms(lambda: eager(params, ost, batch),
                                   iters=2, warmup=0, tries=1)
    log(f"{phase}: the captured step's largest device-time entries: "
        + "; ".join(f"{name} {ms:.1f} ms x{k}" for name, ms, k in
                    top_kernels(lambda: step(params, ost, batch))))
    pool = st["pool_bytes"]
    step.graphs.release()
    del step
    gc.collect()
    torch.cuda.empty_cache()
    account_train(model, params, ost, ocfg, batch, dev, e_dev, n, tokens)
    flops_model = 6 * n * tokens
    flops_remat = 8 * n * tokens
    fb_bound = flops_remat / BF16_FLOPS * 1e3
    model_bound = flops_model / BF16_FLOPS * 1e3
    opt_bytes = KBILL.adamw_update(n, 2, 2).bytes     # bf16 p and g
    opt_bound = opt_bytes / HBM_BYTES_PER_S * 1e3
    mfu = flops_model / (wall_med / 1e3 * BF16_FLOPS)
    e_mfu = flops_model / (eager_wall / 1e3 * BF16_FLOPS)
    log(f"{phase}: full-width gemma-2b training, bf16, {n} parameters in "
        f"{n_leaves} leaves, remat, B {TRAIN_B} S {TRAIN_S} ({tokens} "
        f"tokens a step), build_train_step captured into one CUDA graph: "
        f"losses {[round(x, 4) for x in losses]} ({TRAIN_WARM} eager "
        f"warm-up steps, 1 eager control, the capture, {TRAIN_TIMED} timed "
        f"replays), finite and falling; adamw_update launched "
        f"{counts['adamw_update']} times ({n_leaves} a step), no other "
        f"kernel ({CARD})")
    log(f"{phase}: captured step: wall median {wall_med:.1f} ms over "
        f"{TRAIN_TIMED} replays (host clock, each ending in the loss's "
        f"read; range {min(walls):.1f}-{max(walls):.1f}); traced: device "
        f"{dev_ms:.1f} ms, wall {ev_wall:.1f} ms (CUDA events), idle share "
        f"{1 - dev_ms / ev_wall:.3f}; MFU {flops_model / 1e12:.1f} TFLOP / "
        f"({wall_med / 1e3:.4f} s x {BF16_FLOPS / 1e12:.0f} TFLOP/s) = "
        f"{mfu:.3f}; peak memory {peak / 2**30:.2f} GiB allocated, "
        f"{peak_res / 2**30:.2f} GiB reserved (the capture included); "
        f"capture call {capture_wall:.1f} ms ({st['capture_s']:.2f} s in "
        f"the capture), graph pool {pool / 2**30:.2f} GiB ({CARD})")
    log(f"{phase}: eager control step: wall {eager_wall:.1f} ms (host "
        f"clock); traced: device {e_dev:.1f} ms, wall {e_ev_wall:.1f} ms, "
        f"idle share {1 - e_dev / e_ev_wall:.3f}; MFU {e_mfu:.3f}; peak "
        f"memory {eager_peak / 2**30:.2f} GiB allocated, "
        f"{eager_res / 2**30:.2f} GiB reserved; captured / eager wall "
        f"{wall_med / eager_wall:.3f} ({CARD})")
    b = batch_to(batch, dev)
    fwd_bwd, split_step = _split_parts(model, params, ost, ocfg, b)
    fb_ms, fb_wall, _ = trace_ms(fwd_bwd, iters=3, warmup=1, tries=2)
    grads = fwd_bwd(keep=True)
    opt_ms, opt_wall, _ = trace_ms(
        lambda: OPT.apply_updates(ocfg, params, grads, ost), iters=3,
        warmup=1, tries=2)
    del grads
    split = np.median([split_step() for _ in range(5)], axis=0)
    log(f"{phase}: inside an eager step (CUDA events between its parts, "
        f"median of 5 steps): forward+backward {split[1]:.1f} ms of the "
        f"card's timeline, issued by the host in {split[0]:.1f} ms; AdamW "
        f"{split[2]:.1f} ms ({CARD})")
    log(f"{phase}: hardware bound {fb_bound + opt_bound:.1f} ms = "
        f"forward+backward with remat {flops_remat / 1e12:.1f} TFLOP at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s ({fb_bound:.1f} ms, operations) + "
        f"AdamW {opt_bytes / 1e9:.1f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({opt_bound:.1f} ms, bytes); "
        f"forward+backward device {fb_ms:.1f} ms (wall {fb_wall:.1f}), "
        f"AdamW device {opt_ms:.1f} ms (wall {opt_wall:.1f}): shares "
        f"{fb_ms / (fb_ms + opt_ms):.3f} / {opt_ms / (fb_ms + opt_ms):.3f}; "
        f"captured step / bound {wall_med / (fb_bound + opt_bound):.2f}, "
        f"AdamW / its bound {opt_ms / opt_bound:.2f}, forward+backward / "
        f"its bound {fb_ms / fb_bound:.2f}; model bound "
        f"{model_bound + opt_bound:.1f} ms (6 N T = "
        f"{flops_model / 1e12:.1f} TFLOP, {model_bound:.1f} ms, + AdamW), "
        f"captured step / model bound "
        f"{wall_med / (model_bound + opt_bound):.2f} ({CARD})")
    grads = fwd_bwd(keep=True)
    row = adamw_alone(ops, ref, params, grads, ost, ocfg,
                      counts["adamw_update"], phase)
    del params, ost, model, grads, b, fwd_bwd, split_step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _ulp_gap(a, b, chunk=1 << 26):
    """The largest distance of ``a`` from ``b`` in units in the last place
    of their dtype (float32 or bfloat16): their bit patterns as ordered
    integers, read in chunks of ``chunk`` elements."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int16
    fa, fb = a.reshape(-1).view(it), b.reshape(-1).view(it)
    top = 1 << (8 * a.element_size() - 1)
    worst = 0
    for i in range(0, fa.numel(), chunk):
        x, y = (t[i:i + chunk].long() for t in (fa, fb))
        x = torch.where(x < 0, -top - x, x)
        y = torch.where(y < 0, -top - y, y)
        worst = max(worst, int((x - y).abs().max()))
    return worst


def adamw_alone(ops, ref, params, grads, ost, ocfg, launches, phase):
    """14a: ``adamw_update`` alone over every leaf of the full-width
    state, on its real gradients and moments, against
    ``ref.adamw_update_ref`` on copies: m and v within 1 float32 ulp per
    element, p within 1 ulp of its dtype; the whole update's device time
    beside the plain loop's, its bound (each input read once, each
    output written once: 22 B a bf16 parameter) and
    ``torch._fused_adamw_`` as the library call where it takes these
    leaves (else why not)."""
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import leaves as tree_leaves

    ps, gs, ms, vs = (tree_leaves(t) for t in (params, grads, ost.mu,
                                                ost.nu))
    gnorm = OPT.global_norm(grads)
    scale = (ocfg.clip_norm / gnorm.clamp(min=1e-12)).clamp(max=1.0)
    nxt = ost.step + 1
    lr = OPT.cosine_lr(ocfg, nxt)
    b1c = 1.0 - torch.pow(ocfg.b1, nxt.float())
    b2c = 1.0 - torch.pow(ocfg.b2, nxt.float())
    sc = (scale, lr, b1c, b2c)
    worst, err = {"p": 0, "m": 0, "v": 0}, 0.0
    for p, g, m, v in zip(ps, gs, ms, vs):
        k = [p.clone(), m.clone(), v.clone()]
        ops.adamw_update(k[0], g, k[1], k[2], *sc, ocfg)
        r = [p.clone(), m.clone(), v.clone()]
        ref.adamw_update_ref(r[0], g, r[1], r[2], *sc, ocfg)
        torch.cuda.synchronize()
        for name, x, y in zip("pmv", k, r):
            worst[name] = max(worst[name], _ulp_gap(x, y))
            err = max(err, max_err(x, y))
        del k, r
    n = sum(p.numel() for p in ps)
    leaf_bills = [KBILL.adamw_update(p.numel(), p.element_size(),
                                     g.element_size()) for p, g in zip(ps, gs)]
    bill = KBILL.Bill({"other": sum(b.bytes for b in leaf_bills)},
                      sum(b.flops for b in leaf_bills))
    check(max(worst.values()) <= 1, f"{phase}: adamw_update against its "
          f"plain version on gemma-2b's leaves: {worst} ulps (limit 1)")

    def kern():
        for p, g, m, v in zip(ps, gs, ms, vs):
            ops.adamw_update(p, g, m, v, *sc, ocfg)

    def plain():
        for p, g, m, v in zip(ps, gs, ms, vs):
            ref.adamw_update_ref(p, g, m, v, *sc, ocfg)

    k_t = time_ms(kern, iters=3, warmup=1, tries=2)
    p_t = time_ms(plain, iters=3, warmup=1, tries=2)
    lib, why = None, ""
    try:
        steps = [nxt.float() for _ in ps]
        inv = (1.0 / scale).float()

        def fused():
            torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=float(lr),
                                beta1=ocfg.b1, beta2=ocfg.b2,
                                weight_decay=ocfg.weight_decay,
                                eps=ocfg.eps, amsgrad=False, maximize=False,
                                grad_scale=inv, found_inf=None)

        fused()
        torch.cuda.synchronize()
        lib = time_ms(fused, iters=3, warmup=1, tries=2)
    except (RuntimeError, TypeError, AttributeError) as e:
        why = f"; torch._fused_adamw_ refuses these leaves: " \
              f"{str(e).splitlines()[0][:160]}"
    log(f"{phase}: 14a adamw_update over {len(ps)} leaves of full-width "
        f"gemma-2b ({n} parameters, bf16, float32 moments) against its "
        f"plain version on copies: worst {worst['p']} ulp of p, "
        f"{worst['m']} of m, {worst['v']} of v (limit 1){why} ({CARD})")
    return kernel_row(phase, "adamw_update", launches, err, k_t, p_t,
                      bill, torch.float32, lib,
                      " (one update of every leaf)")


def _graph_batch(cfg, seed, B=2, S=16):
    """Tokens and targets (B, S), 20% masked, and a VLM's image_embeds or
    Whisper's frames (float32), from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rng.random((B, S)) < 0.2] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets}
    if cfg.num_image_tokens:
        batch["image_embeds"] = (0.1 * rng.normal(size=(
            B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.encoder is not None:
        batch["frames"] = (0.1 * rng.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)
    return batch


def _group_gaps(a, b):
    """{"loss", "params", "mu", "nu"}: the largest relative gap of run
    ``a`` from run ``b`` in each (a leaf's max |a - b| over its max |b|)."""
    from repro_torch.tree import leaves as tree_leaves

    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    out = {"loss": float(np.max(np.abs(la - lb) / np.abs(lb)))}
    for k, pa, pb in (("params", a["p"], b["p"]), ("mu", a["o"].mu, b["o"].mu),
                      ("nu", a["o"].nu, b["o"].nu)):
        out[k] = max(_rel_gap(x, y) for x, y in zip(tree_leaves(pa),
                                                    tree_leaves(pb)))
    return out


def train_graph_checks(ops, dev, phase):
    """14b and 14c: every family of ``TRAIN_GRAPH_ARCHS`` reduced, in
    float32, from one state: GRAPH_STEPS eager steps (``graph=False``)
    against the captured step (GRAPH_WARM eager warm-up steps, the
    capture, which replays once, then replays) -- parameters, moments,
    the step and the losses bitwise equal for the dense and state
    families; each within MOE_GAP_FACTOR x its gap between two eager
    runs for the MoE families (the expert gather's backward accumulates
    with atomics); then 14c, a replay whose batch copy into the static
    buffers is left out, must fail that check.  The capture and a replay
    run under ``set_sync_debug_mode("error")``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.train.step_graph import GRAPH_WARM

    ocfg = OPT.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    for arch in TRAIN_GRAPH_ARCHS:
        cfg = get_config(arch).reduced()
        check(cfg.dtype == "float32", f"reduced {arch} is not float32")
        model = build_model(cfg)
        p0 = model.init(seed=0, device=dev)
        batches = [_graph_batch(cfg, i) for i in range(GRAPH_STEPS)]

        def go(graph, plant=False, strict=False):
            p = _tree_to(p0, dev)
            o = OPT.init_state(p)
            step = build_train_step(model, ocfg, device=dev, graph=graph)
            losses = []
            for i, b in enumerate(batches):
                if plant and i == GRAPH_STEPS - 1:
                    # the planted fault: the replay reads the last batch
                    step.graphs._upload = lambda *a: None
                if strict and i == GRAPH_WARM:
                    _strict_body(step.graphs)
                if strict and i == GRAPH_WARM + 1:
                    out = []
                    no_sync(f"reduced {arch}'s captured train step, a "
                            f"replay", lambda: out.append(step(p, o, b)),
                            phase)
                    p, o, m = out[0]
                else:
                    p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
            return {"p": p, "o": o, "losses": losses, "stats": step.stats()}

        t0 = time.perf_counter()
        eager = go(False)
        graph = go(True, strict=arch in GRAPH_SYNC_ARCHS)
        st = graph["stats"]
        check((st["eager_steps"], st["captures"], st["recaptures"],
               st["replays"]) == (GRAPH_WARM, 1, 0, GRAPH_STEPS - GRAPH_WARM),
              f"{phase}: reduced {arch}'s captured step: {st}")
        moe = cfg.moe is not None
        if moe:
            ref_gaps = _group_gaps(go(False), eager)
            limits = {k: max(MOE_GAP_FACTOR * g, MOE_GAP_FLOOR)
                      for k, g in ref_gaps.items()}

            def holds(run):
                gaps = _group_gaps(run, eager)
                return all(gaps[k] <= limits[k] for k in gaps), gaps
        else:
            limits = "bitwise"

            def holds(run):
                same = _bits_equal({"p": run["p"], "o": run["o"]},
                                   {"p": eager["p"], "o": eager["o"]})
                return same and run["losses"] == eager["losses"], same

        ok, seen = holds(graph)
        check(ok, f"{phase}: reduced {arch}: the captured step against "
              f"{GRAPH_STEPS} eager steps: {seen} (limits {limits})")
        what = ""
        if arch in GRAPH_FAULT_ARCHS:
            bad, fseen = holds(go(True, plant=True))
            check(not bad, f"{phase}: reduced {arch}: the planted fault (a "
                  f"replay without its batch copy) passes: {fseen}")
            what = f"; 14c, a replay without its batch copy: {fseen}, fails"
        log(f"{phase}: 14b reduced float32 {arch}: {GRAPH_WARM} eager "
            f"steps + capture + {GRAPH_STEPS - GRAPH_WARM - 1} replay "
            f"against {GRAPH_STEPS} eager steps: "
            + (f"gaps {seen} within {limits} (MOE_GAP_FACTOR x two eager "
               f"runs' {ref_gaps})" if moe else
               "parameters, moments, step and losses bitwise equal")
            + what + ("; capture and replay under set_sync_debug_mode"
                      "('error')" if arch in GRAPH_SYNC_ARCHS else "")
            + f" ({time.perf_counter() - t0:.1f} s)")
        del p0, eager, graph
        gc.collect()
    torch.cuda.empty_cache()


def _strict_body(graphs):
    """Run the captured step's body -- the capture -- under
    ``set_sync_debug_mode("error")``."""
    body = graphs.body

    def strict(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    graphs.body = strict


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
    """14e: reduced gemma_2b through ``train.loop.run`` on the card with
    the captured step, float32 (SyntheticLM) and bfloat16 (MemmapTokens
    over a seeded token file, its TreeArray index on the card, read by
    the prefetch thread while the step captures): 8 steps uninterrupted
    against 4, then a resume to 8; every run captures once and replays,
    the resume copies into the tensors passed in (no recapture), and
    parameters and moments are bitwise equal."""
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

        def go(name, total, first):
            params = model.init(seed=0, device=dev)
            lcfg = TrainLoopConfig(total_steps=total, ckpt_every=4,
                                   ckpt_dir=str(tmp / f"{dtype}-{name}"),
                                   log_every=1000)
            step = build_train_step(model, ocfg, device=dev)
            out = run(step, params, OPT.init_state(params), dcfg, lcfg,
                      device=dev, log=lambda *_: None)
            st = step.stats()
            want = (2, 1, 0, total - first - 2)
            check(st["graph"] and (st["eager_steps"], st["captures"],
                                   st["recaptures"], st["replays"]) == want
                  and out["params"] is params, f"{phase}: reduced gemma_2b "
                  f"{dtype} run {name} to {total}: the step's stats {st}, "
                  f"want (eager, captures, recaptures, replays) {want}")
            return out

        full = go("full", 8, 0)
        go("cut", 4, 0)
        resumed = go("cut", 8, 4)
        same = _bits_equal({"p": full["params"], "o": full["opt_state"]},
                           {"p": resumed["params"], "o": resumed["opt_state"]})
        check(same and full["losses"][4:] == resumed["losses"],
              f"{phase}: reduced gemma_2b {dtype}: the resumed run differs "
              f"from the uninterrupted one")
        log(f"{phase}: 14e reduced gemma_2b {dtype} ({source} data) "
            f"through train.loop.run on the card, the step captured (2 "
            f"eager steps, a capture, then replays in each run): 8 steps "
            f"uninterrupted vs 4 + resume to 8 into the same tensors, "
            f"parameters and moments bitwise equal (losses "
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


def train_path(ops, ref, dev):
    """Phase 14: training on the card; returns ``adamw_update``'s row of
    the kernels line."""
    import tempfile

    phase = "phase 14"
    marks = [("start", time.perf_counter())]
    train_reduced_checks(dev, phase)
    marks.append(("reduced", time.perf_counter()))
    train_graph_checks(ops, dev, phase)
    marks.append(("14b/14c captured vs eager", time.perf_counter()))
    train_cut_check(dev, phase)
    marks.append(("float32 cut", time.perf_counter()))
    row = train_full_width(ops, ref, dev, phase)
    marks.append(("full width (14d, 14a)", time.perf_counter()))
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase14-") as tmp:
        tmp = Path(tmp)
        train_resume_check(dev, tmp, phase)
        marks.append(("resume (14e)", time.perf_counter()))
        train_checkpoint_io(dev, tmp, phase)
        marks.append(("checkpoint", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))
    return row


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
ENC_TRAIN_WARM, ENC_TRAIN_TIMED = 3, 3  # the graph's 2 eager + capture


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
    + 256 text), the step captured with the frames or the image
    embeddings in its static buffers: ENC_TRAIN_WARM untimed steps (the
    graph's eager warm-up and its capture) and ENC_TRAIN_TIMED timed
    replays, finite and falling losses, ``adamw_update`` the only kernel
    launched (one a leaf a step); the step's wall and device time, idle
    share, peak memory and MFU (6 N T at the bf16 peak)."""
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
    n_steps = ENC_TRAIN_WARM + ENC_TRAIN_TIMED
    st = step.stats()
    check(counts["adamw_update"] == len(tree_leaves(params)) * n_steps
          and not any(v for k, v in counts.items() if k != "adamw_update")
          and (st["captures"], st["replays"]) == (1, ENC_TRAIN_TIMED + 1),
          f"{phase}: {n_steps} training steps launched {counts}; the "
          f"step's stats {st}")
    wall = float(np.median(walls[ENC_TRAIN_WARM:])) * 1e3
    dev_ms, ev_wall, _ = trace_ms(lambda: step(params, ost, batch),
                                  iters=2, warmup=0, tries=1)
    mfu = flops / (wall / 1e3 * BF16_FLOPS)
    log(f"{phase}: full-width {cfg.name} training, bf16, {n} parameters, "
        f"remat, {what} = {flops / 1e12:.3f} TFLOP a step: losses "
        f"{[round(x, 4) for x in losses]} ({ENC_TRAIN_WARM} untimed, then "
        f"{ENC_TRAIN_TIMED} timed replays of the captured step), finite "
        f"and falling; adamw_update launched {counts['adamw_update']} "
        f"times, no other kernel; step wall median {wall:.1f} ms (host "
        f"clock); traced device "
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
        part = {"whisper_tiny": "phase 21a", "internvl2_1b": "phase 21b"}[arch]
        tp_encdec_served(ops, ref, dev, model, params, part)
        mark_part(part)
        marks.append((part, time.perf_counter()))
        encdec_train(ops, model, params, dev, phase)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        marks.append(("training", time.perf_counter()))
    log(f"{phase}: time split (s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}"
        for i, (name, t) in enumerate(marks[1:])))


# ---------------------------------------------------------------------------
# phase 21: Whisper-tiny and InternVL2-1B over the model axis
# ---------------------------------------------------------------------------
#: layers of 21c's float32 InternVL2-1B cut (Whisper-tiny runs whole)
TP_VLM_CUT = 2
TP_ENC_CUT_B, TP_ENC_CUT_S = 2, 64     # 21c's rows and text tokens
#: 21c's limit on the loss and the clip norm, relative (the leaves keep
#: TP_CUT_TOL of their max)
TP_ENC_LOSS_TOL = 1e-6


def _cross_unsummed(p, x, kv, cfg, *, positions, seq_parallel=False):
    """The planted cross-attention fault: ``attention.gqa_cross`` with
    ``wo``'s product left unsummed over the model axis, each rank
    keeping its own heads' part."""
    from repro_torch.launch import shardings as SH
    from repro_torch.models import attention as A
    from repro_torch.models.common import flash_attention

    split = p["wq"].shape[-1] != cfg.num_heads * cfg.hd
    if seq_parallel and split:
        x = SH.seq_gather(x)
    q = A._heads(p, x, "wq", "q_norm", cfg, positions)
    o = flash_attention(q, *kv, causal=False, scale=cfg.query_scale)
    y = o.reshape(*x.shape[:2], -1) @ p["wo"]
    return SH.seq_piece(y, 1) if seq_parallel and split else y


def _plant_cross_fault():
    """Plant the cross-attention fault for every rank of this process;
    returns the undo."""
    from repro_torch.models import attention as A

    real = A.gqa_cross
    A.gqa_cross = _cross_unsummed
    return lambda: setattr(A, "gqa_cross", real)


def _text_without_gather(self, x, S):
    """The planted image-prefix fault: ``DecoderLM._text_positions`` with
    the sequence piece's gather left out (the other ranks' positions of
    the prefixed stream read zeros)."""
    from repro_torch.launch import shardings as SH

    I = self.cfg.num_image_tokens
    if SH.is_piece(x, I + S, dim=1):
        n, r = x.shape[1], SH.model_mesh().axis_index("model")
        lead, rest = (x.shape[0],), tuple(x.shape[2:])
        x = torch.cat([x.new_zeros(lead + (r * n,) + rest), x,
                       x.new_zeros(lead + (I + S - (r + 1) * n,) + rest)],
                      dim=1)
    return x[:, I:]


def _plant_prefix_fault():
    """Plant the image-prefix fault in this process; returns the undo."""
    from repro_torch.models.lm import DecoderLM

    real = DecoderLM._text_positions
    DecoderLM._text_positions = _text_without_gather
    return lambda: setattr(DecoderLM, "_text_positions", real)


def _encdec_against_one(model, params, inp, feed=None, fault=None,
                        planted=None, record=None):
    """Phase 15's prompt (no suffix) and MESH_STEPS decode steps of
    ``model`` on one device (fed ``feed``, else its greedy tokens) and
    on a (1, 2) mesh of gloo thread ranks sharing the card, fed the
    one-device tokens, each on a fresh state over ``inp``'s tables;
    ``fault`` and ``planted`` as in ``_tp_against_one``.  Returns (gap,
    tokens equal, each rank's launches, the ranks' results, the
    one-device logits, its tokens)."""
    from repro_torch.launch.mesh import run_ranks

    kw = {k: inp[k] for k in ("frames", "image_embeds") if k in inp}
    one, fed, _ = _greedy17(
        lambda p, t, c, n: model.prefill(p, t, c, n, **kw),
        lambda p, t, c: model.decode_step(p, t, c), params, inp["toks"],
        inp["lens"], _state15(model, inp), feed)
    glob = _state15(model, inp)
    if record is not None:
        record.install()
    undo = planted() if planted is not None else None
    try:
        res = run_ranks((1, 2), lambda m: _tp_check_run(
            m, model, params, glob, inp["toks"], inp["lens"], fed, fault,
            kw), backend="gloo", device=inp["toks"].device)
    finally:
        if undo is not None:
            undo()
        if record is not None:
            record.remove()
    rel, same = _tp_gap(res[0][0], one)
    return rel, same, [r[1] for r in res], res, one, fed


def tp_encdec_served(ops, ref, dev, model, params, phase):
    """21a (Whisper-tiny) or 21b (InternVL2-1B), inside phase 15 on its
    served bf16 weights at published widths: a (1, 2) mesh of gloo
    thread ranks sharing the card -- the attention heads split (Whisper:
    the encoder's, the self and the cross attention's; its cross K/V
    computed at prefill from each rank's ``wk``/``wv`` columns), the MLP
    split, the vocabulary whole (51865 and 151655 do not divide 2) --
    prefills phase 15's ``ENC_B`` rows (Whisper: ``WHISPER_PROMPTS`` over
    1500 stub frames; InternVL2: 256 image tokens and ``VLM_PREFIX``)
    and decodes MESH_STEPS steps against the one-device steps: gathered
    logits within TP_LOGIT_TOL of max |logit|, greedy tokens equal except
    where the one-device top-2 margin is within both the gap and
    TP_LOGIT_TOL; #1 counted on each rank (once a layer a step) and held
    against its plain version at the rank's KVH, G, HD; each rank's
    collectives and staged bytes.  Then the same in float32 within
    F32_LOGIT_TOL, which a planted fault must exceed (Whisper: the cross
    attention's ``wo`` left unsummed; InternVL2: the ranks' attention
    ``wo`` rows swapped).  Returns the part's seconds."""
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = model.cfg
    name, whisper = cfg.name, cfg.encoder is not None
    inp = _inputs15(model, dev, seed=21)
    rec = Recorder(ops, ("paged_attention_append",))
    rel, _, launches, res, one, fed = _encdec_against_one(
        model, params, inp, record=rec)
    ties = _near_ties(res[0][0], one)
    stats = [r[4] for r in res]
    del res, one
    per_rank = [c.get("paged_attention_append", 0) for c in launches]
    (q, *_), _ = rec.last["paged_attention_append"]
    shape = tuple(q.shape[1:])
    want = (cfg.kv_heads // 2, cfg.num_heads // cfg.kv_heads, cfg.hd)
    check(per_rank == [cfg.num_layers * MESH_STEPS] * 2 and shape == want,
          f"{phase}: #1 launches per rank {per_rank} at (KVH, G, HD) "
          f"{shape}, want {cfg.num_layers * MESH_STEPS} at {want}")
    measure_append(ops, ref, rec.last,
                   {"paged_attention_append": per_rank[0]}, phase)
    del rec
    f32 = torch.float32
    m32 = _rebuild(model, dtype=f32)
    p32 = tree_map(lambda x: x.to(f32), params)
    gaps = {}
    for fault in (False, True):
        g, same, *_ = _encdec_against_one(
            m32, p32, inp, feed=fed,
            fault=_swap_wo if fault and not whisper else None,
            planted=_plant_cross_fault if fault and whisper else None)
        gaps[fault] = (g, same)
    del m32, p32, inp
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"{phase}: 2 gloo ranks on one card, {name}'s served weights "
        f"({cfg.dtype}, published widths, {cfg.num_layers} layers) over "
        f"the model axis, B {ENC_B}: gathered logits vs the one-device "
        f"steps {rel:.4e} of max |logit| over the prefill and "
        f"{MESH_STEPS} steps (tol {TP_LOGIT_TOL}); greedy tokens differ at "
        f"{len(ties)} of {ENC_B * (MESH_STEPS + 1)} (step, row, one-device "
        f"top-2 margin of max |logit|): {ties}; #1 launched {per_rank} "
        f"times by the ranks at (KVH, G, HD) {shape}; each rank's "
        f"collectives {[st['calls'] for st in stats]}, "
        f"{[st['staged_bytes'] for st in stats]} B staged ({CARD})")
    check(rel <= TP_LOGIT_TOL
          and all(mg <= min(rel, TP_LOGIT_TOL) for _, _, mg in ties),
          f"{phase}: the tensor-parallel steps differ from the one-device "
          f"steps: {rel:.4e}, tokens {ties}")
    what = ("the cross attention's wo left unsummed" if whisper else
            "the ranks' attention wo rows swapped")
    log(f"{phase}: 2 gloo ranks, {name} in float32: gathered logits vs one "
        f"device {gaps[False][0]:.3e} of max |logit| (tol {F32_LOGIT_TOL}), "
        f"greedy tokens {'equal' if gaps[False][1] else 'DIFFERENT'}; "
        f"planted fault ({what}) {gaps[True][0]:.3e}; {secs:.1f} s")
    check(gaps[False][0] <= F32_LOGIT_TOL and gaps[False][1],
          f"{phase}: float32 tensor-parallel logits differ: "
          f"{gaps[False][0]:.3e}")
    check(gaps[True][0] > F32_LOGIT_TOL, f"{phase}: the planted fault stays "
          f"within the limit: {gaps[True][0]:.3e}")
    return secs


def _encdec_cut_batch(cfg):
    """21c's batch: TP_ENC_CUT_B rows of TP_ENC_CUT_S text tokens (every
    fifth target masked) with 1500 stub frames or 256 stub image
    tokens, float32 from seed 0."""
    rng = np.random.default_rng(0)
    B, S, d = TP_ENC_CUT_B, TP_ENC_CUT_S, cfg.d_model
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][:, ::5] = -1
    if cfg.encoder is not None:
        batch["frames"] = (0.1 * rng.normal(size=(
            B, cfg.encoder.num_frames, d))).astype(np.float32)
    else:
        batch["image_embeds"] = (0.1 * rng.normal(size=(
            B, cfg.num_image_tokens, d))).astype(np.float32)
    return batch


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


# ---------------------------------------------------------------------------
# phase 17: the data axis of the mesh
# ---------------------------------------------------------------------------
MESH_B = 8                         # rows of the full-width serve steps
MESH_PROMPTS = (64, 40, 17, 64, 33, 64, 50, 9)
MESH_STEPS = 4                     # decode steps after the prefill
MESH_TRAIN_B, MESH_TRAIN_S = 2, 64  # the two-layer cut's batch: a row a rank
MESH_STEP_TOL = 1e-5               # data-parallel vs global step
COMPRESSED_TOL = 2e-3              # the reference's relative distance
# the data-parallel gate's AdamW: eps 1 and lr 1 make the update smooth in
# the gradient and as large as it (at eps 1e-8 an element whose gradient
# is at noise moves by +-lr either way); the compressed step takes the
# reference test's settings
MESH_OPT = dict(lr_peak=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0)
COMPRESSED_OPT = dict(lr_peak=1e-3, warmup_steps=1, total_steps=5)


def _mesh_cache(model, dev, B, dp, width, seed):
    """A global paged cache of ``B`` rows over ``dp`` pool groups, each
    group's blocks dealt to its rows in a seeded shuffled order
    (group-local ids), and seeded prompts of ``width`` tokens."""
    from repro_torch.core.paged_kv import PagedKVCache

    bt = model.cfg.kv_block_tokens
    mbs = -(-(width + MESH_STEPS) // bt)
    kv = model.kv_config(max_seq=mbs * bt, num_blocks=B * mbs, batch=B,
                         dp_groups=dp)
    cache = PagedKVCache.create(kv, B, device=dev)
    rng = np.random.default_rng(seed)
    rows = B // dp
    tables = np.concatenate([rng.permutation(rows * mbs).reshape(rows, mbs)
                             for _ in range(dp)]).astype(np.int32)
    cache.block_tables.copy_(torch.as_tensor(tables))
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    toks = torch.randint(2, model.cfg.vocab_size, (B, width), generator=g)
    return cache, toks.to(dev)


def _greedy17(prefill, serve, params, toks, lens, state, feed=None,
              after_prefill=None):
    """Prefill, then MESH_STEPS decode steps fed ``feed`` (or greedy):
    the logits of each, and the tokens fed.  ``after_prefill(state)``
    runs between the two."""
    last, state = prefill(params, toks, state, lens)
    if after_prefill is not None:
        after_prefill(state)
    out, fed = [last], []
    for i in range(MESH_STEPS):
        nxt = (feed[i] if feed is not None
               else out[-1].argmax(-1).to(torch.int32))
        fed.append(nxt)
        lg, state = serve(params, nxt, state)
        out.append(lg)
    return out, fed, state


def _rows17(mesh, x):
    from repro_torch.launch import steps as STEPS
    return STEPS.shard_rows(mesh, x, STEPS.batch_shardings(
        mesh, {"x": x}, x.shape[0])["x"])


def _mesh_serve(mesh, model, params, glob, toks, lens, feed=None,
                fault=False):
    """This rank's prefill and decode steps on its piece of ``glob``:
    (the gathered logits of each step, this rank's kernel launches, the
    wall seconds of the prefill and of the decode steps)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as STEPS

    local = STEPS.shard_state(mesh, glob, model.cfg)

    def plant(state):
        # planted: after its prompt was written, this rank's first row
        # reads its first two blocks swapped
        if fault and mesh.rank == 1:
            state.block_tables[0, :2] = state.block_tables[0, :2].flip(0)

    prefill = STEPS.build_prefill_step(model, mesh=mesh, state_example=glob)
    serve = STEPS.build_serve_step(model, mesh=mesh, state_example=glob)
    mine = None if feed is None else [_rows17(mesh, f) for f in feed]
    ops.reset_thread_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, _ = _greedy17(prefill, serve, params, _rows17(mesh, toks),
                          _rows17(mesh, lens), local, mine, plant)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.thread_launch_counts()
    return [STEPS.gather_rows(mesh, o) for o in out], launches, dt


def _step_gap(new, old, want):
    """max over leaves of |new - want| over (max |want - old| + the
    float32 rounding of ``want``): a step against the global step."""
    from repro_torch.tree import leaves as tree_leaves

    worst = 0.0
    for a, o, w in zip(tree_leaves(new), tree_leaves(old), tree_leaves(want)):
        scale = (float((w - o).abs().max())
                 + float(w.abs().max()) * float(torch.finfo(w.dtype).eps)
                 / MESH_STEP_TOL)
        worst = max(worst, float((a - w).abs().max()) / max(scale, 1e-30))
    return worst


def _cut17(dev):
    """Phase 14's two-layer full-width float32 cut of gemma-2b (seed 0)
    and a batch of MESH_TRAIN_B rows with every 5th target masked."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(full_width_config(), num_layers=TRAIN_CUT,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=MESH_TRAIN_S,
                               global_batch=MESH_TRAIN_B, seed=0)).batch_at(0)
    b["targets"] = b["targets"].copy()
    b["targets"][0, ::5] = -1          # the rows hold different counts
    return model, params, b


def _bitwise(a, b):
    from repro_torch.tree import leaves as tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def mesh_one_rank(ops, dev, model, params, phase):
    """A 1 x 1 NCCL mesh from a HashStore (no init_process_group): its
    serve and prefill steps on phase 3's full-width weights, and its
    train step with and without ZeRO-1 on the two-layer float32 cut,
    bit for bit against the one-device calls; the serve step's wall and
    device time beside the one-device one's."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim import adamw as OPT

    lens = torch.tensor(MESH_PROMPTS, dtype=torch.int32, device=dev)
    m32, p0, batch = _cut17(dev)
    ocfg = OPT.AdamWConfig(**MESH_OPT)
    p_one = _tree_to(p0, dev)
    one = STEPS.build_train_step(m32, ocfg, device=dev)
    o_one = OPT.init_state(p_one)
    p_one, o_one, m_one = one(p_one, o_one, batch)

    def serve(mesh):
        log(f"{phase}: {mesh.describe()}")
        ca, toks = _mesh_cache(model, dev, MESH_B, 1, 64, 17)
        cb, _ = _mesh_cache(model, dev, MESH_B, 1, 64, 17)
        one, fed, ca = _greedy17(
            lambda p, t, c, l: model.prefill(p, t, c, l),
            lambda p, t, c: model.decode_step(p, t, c), params, toks, lens,
            ca)
        ops.reset_launch_counts()
        got, launches, _ = _mesh_serve(mesh, model, params, cb, toks, lens)
        check(all(torch.equal(a, b) for a, b in zip(got, one))
              and torch.equal(ca.k_pool, cb.k_pool)
              and torch.equal(ca.v_pool, cb.v_pool),
              f"{phase}: the 1 x 1 mesh's prefill/serve steps differ from "
              f"prefill/decode_step")
        check(launches["paged_attention_append"]
              == MESH_STEPS * model.cfg.num_layers,
              f"{phase}: #1 launched {launches} on the mesh")
        step = STEPS.build_serve_step(model, mesh=mesh, state_example=cb)
        nxt = fed[-1]
        t_mesh = time_ms(lambda: step(params, nxt, cb), iters=10, warmup=2,
                         tries=STEP_TRIES)
        t_one = time_ms(lambda: model.decode_step(params, nxt, ca),
                        iters=10, warmup=2, tries=STEP_TRIES)
        log(f"{phase}: 1 x 1 nccl mesh, full-width gemma-2b bf16, B "
            f"{MESH_B}: prefill + {MESH_STEPS} serve steps equal "
            f"prefill/decode_step bit for bit (logits and pools), #1 "
            f"launched {launches['paged_attention_append']} times; a "
            f"serve step {t_mesh[1]:.3f} ms wall / {t_mesh[0]:.3f} ms "
            f"device vs decode_step {t_one[1]:.3f} / {t_one[0]:.3f} "
            f"({CARD})")

    def train(mesh):
        out = {}
        for zero1 in (False, True):
            p = _tree_to(p0, dev)
            step = STEPS.build_train_step(m32, ocfg, mesh=mesh, zero1=zero1)
            o = STEPS.init_opt_state(mesh, p, step.in_shardings[1])
            p, o, m = step(p, o, STEPS.shard_batch(mesh, batch))
            check(float(m["loss"]) == float(m_one["loss"])
                  and _bitwise(p, p_one) and _bitwise(
                      STEPS.gather_opt_state(mesh, o, step.in_shardings[1]),
                      o_one),
                  f"{phase}: the 1 x 1 mesh's train step (zero1={zero1}) "
                  f"differs from build_train_step")
            del p, o
        return out

    def both(mesh):
        serve(mesh)
        return train(mesh)

    run_ranks((1, 1), both, backend="nccl", device=dev)
    log(f"{phase}: 1 x 1 nccl mesh, gemma-2b cut to {TRAIN_CUT} layers, "
        f"float32, B {MESH_TRAIN_B} S {MESH_TRAIN_S}: the train step and "
        f"the ZeRO-1 step equal build_train_step bit for bit (loss "
        f"{float(m_one['loss']):.6f}, parameters, moments; untimed, to "
        f"leave time for phase 19) ({CARD})")
    del p_one, o_one


def mesh_two_ranks_serve(ops, dev, model, params, phase):
    """Two gloo thread ranks sharing the card: the full-width serve step
    at B 8 over dp_groups=2 pools on read-only weights both ranks share,
    against the one-device step (bf16 tolerance, equal greedy tokens, #1
    on each rank); then reduced float32 gemma-2b within 1e-5 of
    max|logit|, which a planted table fault must exceed."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.api import build_model

    lens = torch.tensor(MESH_PROMPTS, dtype=torch.int32, device=dev)
    ca, toks = _mesh_cache(model, dev, MESH_B, 2, 64, 23)
    one, fed, ca = _greedy17(
        lambda p, t, c, l: model.prefill(p, t, c, l),
        lambda p, t, c: model.decode_step(p, t, c), params, toks, lens, ca)
    cb, _ = _mesh_cache(model, dev, MESH_B, 2, 64, 23)
    t0 = time.perf_counter()
    res = run_ranks((2, 1), lambda m: _mesh_serve(m, model, params, cb, toks,
                                                  lens, feed=fed) + (
        m.stats.to_dict(), m.describe()), backend="gloo", device=dev)
    wall = time.perf_counter() - t0
    got = res[0][0]
    rel = max(max_err(a, b) / float(b.float().abs().max())
              for a, b in zip(got, one))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(got, one))
    per_rank = [r[1]["paged_attention_append"] for r in res]
    log(f"{phase}: {res[0][4]}")
    log(f"{phase}: 2 gloo ranks on one card, full-width gemma-2b bf16, B "
        f"{MESH_B} over dp_groups=2 pools (each rank its 4 rows and 8 "
        f"blocks, group-local tables), weights shared: gathered logits vs "
        f"the one-device step {rel:.4e} of max |logit| (tol {LOGIT_TOL}) "
        f"over the prefill and {MESH_STEPS} steps, greedy tokens "
        f"{'equal' if same else 'DIFFERENT'}; #1 launched {per_rank} "
        f"times by the ranks; prefill + steps {res[0][2]:.3f} / "
        f"{res[1][2]:.3f} s a rank, {wall:.2f} s with the groups; "
        f"collectives rank 0 {res[0][3]} ({CARD})")
    check(rel <= LOGIT_TOL and same, f"{phase}: the 2-rank serve step "
          f"differs from the one-device step")
    check(per_rank == [MESH_STEPS * model.cfg.num_layers] * 2,
          f"{phase}: #1 launches per rank {per_rank}")

    cfg = get_config("gemma_2b").reduced()
    rm = build_model(cfg)
    rp = rm.init(seed=3, device=dev)
    rlens = torch.tensor([24, 13, 7, 24], dtype=torch.int32, device=dev)
    gaps = {}
    for fault in (False, True):
        ra, rtoks = _mesh_cache(rm, dev, 4, 2, 24, 5)
        rone, rfed, _ = _greedy17(
            lambda p, t, c, l: rm.prefill(p, t, c, l),
            lambda p, t, c: rm.decode_step(p, t, c), rp, rtoks, rlens, ra)
        rb, _ = _mesh_cache(rm, dev, 4, 2, 24, 5)
        rres = run_ranks((2, 1), lambda m: _mesh_serve(
            m, rm, rp, rb, rtoks, rlens, feed=rfed, fault=fault),
            backend="gloo", device=dev)
        gaps[fault] = max(max_err(a, b) / float(b.abs().max())
                          for a, b in zip(rres[0][0], rone))
    log(f"{phase}: 2 gloo ranks, reduced float32 gemma-2b, B 4 over "
        f"dp_groups=2: gathered logits vs one device {gaps[False]:.3e} of "
        f"max |logit| (tol {MESH_STEP_TOL}); planted fault (after the "
        f"prefill, rank 1's first row reads its first two blocks swapped) "
        f"{gaps[True]:.3e}")
    check(gaps[False] <= MESH_STEP_TOL, f"{phase}: reduced 2-rank logits "
          f"differ: {gaps[False]:.3e}")
    check(gaps[True] > MESH_STEP_TOL, f"{phase}: the planted table fault "
          f"stays within the limit: {gaps[True]:.3e}")


def _reduced17(dev):
    """Reduced float32 gemma-2b (seed 0) and a batch of MESH_TRAIN_B
    rows of MESH_TRAIN_S tokens, every 5th target of row 0 masked: the
    2-rank train steps' model.  (On the two-layer full-width cut they
    took ~20 s of gloo staging, which the script's time limit could not
    keep once the model axis joined.)"""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.api import build_model

    cfg = get_config("gemma_2b").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=MESH_TRAIN_S,
                               global_batch=MESH_TRAIN_B, seed=0)).batch_at(0)
    b["targets"] = b["targets"].copy()
    b["targets"][0, ::5] = -1
    return model, params, b


def mesh_two_ranks_train(dev, m32, p0, batch, phase):
    """Two gloo ranks on the card, reduced float32 gemma-2b: the
    data-parallel step within MESH_STEP_TOL of the global step, ZeRO-1
    equal to it bit for bit, the int8 error-feedback step within the
    reference's 2e-3 of the exact update with a nonzero residual; the
    bytes each sync moved and the bytes staged through the host."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim import adamw as OPT
    from repro_torch.train.compressed import (build_compressed_train_step,
                                              init_residual)

    ocfg = OPT.AdamWConfig(**MESH_OPT)
    glob = _tree_to(p0, dev)
    g_loss = STEPS.build_train_step(m32, ocfg, device=dev)(
        glob, OPT.init_state(glob), batch)[2]["loss"]
    kept = {}

    def dp(zero1):
        def fn(mesh):
            p = _tree_to(p0, dev)
            step = STEPS.build_train_step(m32, ocfg, mesh=mesh, zero1=zero1)
            o = STEPS.init_opt_state(mesh, p, step.in_shardings[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(p, o, STEPS.shard_batch(mesh, batch))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if mesh.rank == 0:
                if zero1:
                    check(_bitwise(p, kept["dp"]), f"{phase}: ZeRO-1 "
                          f"differs from the data-parallel step")
                else:
                    kept["dp"] = p
            return float(m["loss"]), dt, mesh.stats.to_dict(), \
                _step_gap(p, p0, glob)
        return run_ranks((2, 1), fn, backend="gloo", device=dev)

    plain = dp(False)
    gc.collect()
    torch.cuda.empty_cache()
    zero = dp(True)
    kept.clear()
    lgap = abs(plain[0][0] - float(g_loss)) / abs(float(g_loss))
    log(f"{phase}: 2 gloo ranks, reduced float32 gemma-2b, a row a rank: "
        f"loss {plain[0][0]:.6f} vs the global "
        f"step's {float(g_loss):.6f} (rel {lgap:.3e}), parameters' step "
        f"within {plain[0][3]:.3e} of each leaf's largest step (tol "
        f"{MESH_STEP_TOL}); ZeRO-1 equal bit for bit; step wall "
        f"{plain[0][1]:.2f} s (ZeRO-1 {zero[0][1]:.2f} s); rank 0 "
        f"collectives {plain[0][2]} (ZeRO-1 {zero[0][2]}) ({CARD})")
    check(lgap <= MESH_STEP_TOL and plain[0][3] <= MESH_STEP_TOL,
          f"{phase}: the data-parallel step differs from the global step")
    del glob
    gc.collect()
    torch.cuda.empty_cache()
    ccfg = OPT.AdamWConfig(**COMPRESSED_OPT)
    exact = _tree_to(p0, dev)
    STEPS.build_train_step(m32, ccfg, device=dev)(
        exact, OPT.init_state(exact), batch)

    def comp(mesh):
        p = _tree_to(p0, dev)
        step = build_compressed_train_step(m32, mesh, ccfg)
        o = OPT.init_state(p)
        res = init_residual(p, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, res, m = step(p, o, res, STEPS.shard_batch(mesh, batch))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        num = den = 0.0
        for a, b in zip(_leaves(p), _leaves(exact)):
            num += float((a.float() - b.float()).square().sum())
            den += float(b.float().square().sum())
        return ((num / max(den, 1e-30)) ** 0.5, float(res.abs().max()),
                dt, mesh.stats.to_dict(), res.numel())

    out = run_ranks((2, 1), comp, backend="gloo", device=dev)
    rel, rmax, dt, stats, n = out[0]
    f32 = plain[0][2]["bytes"].get("all_reduce", 0)
    i8 = stats["bytes"].get("all_gather", 0)
    log(f"{phase}: 2 gloo ranks, the int8 error-feedback step: relative "
        f"distance to the exact update {rel:.3e} (tol {COMPRESSED_TOL}), "
        f"residual max {rmax:.3e} over {n} values, step wall {dt:.2f} s; "
        f"sync bytes a rank handed in: int8 codes + scales {i8} vs the "
        f"float32 all-reduce's {f32} ({f32 / max(i8, 1):.2f}x); staged "
        f"through pinned host memory: {stats['staged_bytes']} B "
        f"(data-parallel step {plain[0][2]['staged_bytes']} B) ({CARD})")
    check(rel < COMPRESSED_TOL and rmax > 0, f"{phase}: the compressed step "
          f"strays {rel:.3e} from the exact update (residual {rmax:.3e})")
    del exact


def _leaves(tree):
    from repro_torch.tree import leaves as tree_leaves
    return tree_leaves(tree)


def mesh_path(ops, dev, model, params):
    """Phase 17 on phase 3's full-width weights; alone: import
    ``chip_smoke``, set ``CARD``, build a full-width gemma-2b and call
    ``chip_smoke.mesh_path(ops, dev, model, params)``."""
    phase = "phase 17"
    t0 = time.perf_counter()
    mesh_one_rank(ops, dev, model, params, phase)
    t1 = time.perf_counter()
    mesh_two_ranks_serve(ops, dev, model, params, phase)
    t2 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    m32, p0, batch = _reduced17(dev)
    mesh_two_ranks_train(dev, m32, p0, batch, phase)
    log(f"{phase}: 1 x 1 mesh {t1 - t0:.1f} s, 2-rank serve "
        f"{t2 - t1:.1f} s, 2-rank train {time.perf_counter() - t2:.1f} s")
    del m32, p0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 18: the model axis of the mesh (Megatron tensor and expert
# parallelism in the serve and prefill steps)
# ---------------------------------------------------------------------------
# gemma-2b bf16 at tp 2 against one device, of max |logit|: the row-
# parallel sums are float32 and round once, as the one-device product
# does, but the column products run on half the columns (another cuBLAS
# tiling), which flips a bf16 rounding here and there and compounds over
# 18 layers; phase 17's data-parallel run (M 4 vs M 8 products) read
# 5.43e-04.  The limit is about 2.5 bf16 steps of the largest logit;
# greedy tokens must be equal besides
TP_LOGIT_TOL = 1e-2
TP_TIMED_STEPS = 10                # timed serve steps of the 2-rank mesh
TP_B, TP_WIDTH = 4, 64             # the float32 cuts' rows and prompts
TP_SERVED_DEPTH = 12               # layers of 18b's bf16 reading (views)
TP_PROMPTS = (64, 37, 50, 13)
#: the moment main() started, for the phase marks of parts run inside
#: other phases
T_START = None


def mark_part(part):
    if T_START is not None:
        mark(part, T_START)


def _tp_check_run(mesh, model, params, glob, toks, lens, feed, fault=None,
                  kw=None):
    """This rank's prefill and decode steps over the model axis on its
    pieces of ``params`` and ``glob`` (``fault(mesh, pieces, params)``
    may plant a fault in its pieces; ``kw``, the prefill's stub inputs,
    its rows of them): (the gathered logits of each step, its kernel
    launches, its pieces, its state, its collectives)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as STEPS

    step = STEPS.build_prefill_step(model, mesh=mesh, state_example=glob)
    rows = {k: _rows17(mesh, v) for k, v in (kw or {}).items()}

    def prefill(p, t, c, n):
        return step(p, t, c, n, **rows)

    serve = STEPS.build_serve_step(model, mesh=mesh, state_example=glob)
    mine = STEPS.shard_params(mesh, params, serve.in_shardings)
    if fault is not None:
        mine = fault(mesh, mine, params)
    local = STEPS.shard_state(mesh, glob, model.cfg)
    ops.reset_thread_launch_counts()
    out, _, local = _greedy17(prefill, serve, mine, _rows17(mesh, toks),
                              _rows17(mesh, lens), local,
                              [_rows17(mesh, f) for f in feed])
    torch.cuda.synchronize()
    launches = ops.thread_launch_counts()
    stats = mesh.stats.to_dict()
    return ([STEPS.gather_logits(mesh, o, model.cfg.vocab_size)
             for o in out], launches, mine, local, stats)


def _tp_gap(got, one):
    """max over the steps of |mesh - one device| / max |one device|, and
    whether every step's greedy tokens agree."""
    rel = max(max_err(a, b) / float(b.float().abs().max())
              for a, b in zip(got, one))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(got, one))
    return rel, same


def _mesh_state(model, dev, B, width, seed):
    """A global decode state of ``B`` rows for ``model`` -- a paged cache
    (``_mesh_cache``, one pool group), the hybrid's recurrent state with
    one, or RWKV6's -- and seeded prompts of ``width`` tokens."""
    from repro_torch.models.zamba2 import ZambaState

    if not hasattr(model, "kv_config"):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        toks = torch.randint(2, model.cfg.vocab_size, (B, width),
                             generator=g)
        return model.init_state(B, device=dev), toks.to(dev)
    cache, toks = _mesh_cache(model, dev, B, 1, width, seed)
    if hasattr(model, "init_recurrent"):
        return ZambaState(*model.init_recurrent(B, device=dev), cache), toks
    return cache, toks


def _tp_against_one(model, params, dev, B, prompts, seed, fault=None,
                    record=None, feed=None, planted=None):
    """Prefill and MESH_STEPS decode steps of ``model`` on one device
    (fed ``feed``, else its greedy tokens) and on a (1, 2) mesh of gloo
    thread ranks sharing the card, the mesh fed the one-device tokens;
    ``planted()`` plants a fault in the code for the mesh run and returns
    its undo.  Returns (gap, tokens equal, each rank's launches, the
    ranks' results, the one-device logits, its tokens, its state)."""
    from repro_torch.launch.mesh import run_ranks

    lens = torch.tensor(prompts, dtype=torch.int32, device=dev)
    width = max(prompts)
    ca, toks = _mesh_state(model, dev, B, width, seed)
    one, fed, ca = _greedy17(
        lambda p, t, c, l: model.prefill(p, t, c, l),
        lambda p, t, c: model.decode_step(p, t, c), params, toks, lens, ca,
        feed)
    cb, _ = _mesh_state(model, dev, B, width, seed)
    if record is not None:
        record.install()
    undo = planted() if planted is not None else None
    try:
        res = run_ranks((1, 2), lambda m: _tp_check_run(
            m, model, params, cb, toks, lens, fed, fault),
            backend="gloo", device=dev)
    finally:
        if undo is not None:
            undo()
        if record is not None:
            record.remove()
    rel, same = _tp_gap(res[0][0], one)
    return rel, same, [r[1] for r in res], res, one, fed, ca


def _swap_wo(mesh, mine, params):
    """The planted fault: this rank reads the other rank's rows of every
    layer's attention ``wo`` (``mine`` is a tree of its own)."""
    wo = params["layers"]["attn"]["wo"]
    half = wo.shape[1] // 2
    other = 1 - mesh.axis_index("model")
    mine["layers"]["attn"]["wo"] = wo.narrow(1, other * half, half)
    return mine


#: kernel-name fragments of the matrix products (cuBLAS, CUTLASS) and of
#: the copies, fills and casts in a trace
PRODUCT_NAMES = ("gemm", "cutlass", "xmma", "cublas", "splitk", "nvjet")
COPY_NAMES = ("memcpy", "memset", "copy_kernel", "fill")


def _kernel_split(prof, steps):
    """A trace's device time a step (ms) by kind -- products, copies and
    fills, the rest -- and its six heaviest kernels, name-clipped."""
    kinds = {"products": 0.0, "copies": 0.0, "rest": 0.0}
    rows = []
    for e in prof.key_averages():
        ms = _device_us(e) / 1e3 / steps
        if ms <= 0:
            continue
        low = e.key.lower()
        kind = ("products" if any(w in low for w in PRODUCT_NAMES) else
                "copies" if any(w in low for w in COPY_NAMES) else "rest")
        kinds[kind] += ms
        rows.append((round(ms, 4), e.key[:56]))
    rows.sort(reverse=True)
    return {k: round(v, 4) for k, v in kinds.items()}, rows[:6]


def _tp_timed(model, dev, res, nxt):
    """TP_TIMED_STEPS serve steps on each rank's pieces and state left by
    the check run, under one torch.profiler trace of the card: (wall ms
    a step, device ms a step -- both ranks' kernels and copies --, rank
    0's collectives a step, the device time's split by kernel)."""
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import run_ranks

    def fn(mesh):
        mine, local = res[mesh.rank][2:4]
        serve = STEPS.build_serve_step(model, mesh=mesh)
        for _ in range(2):
            _, local = serve(mine, nxt, local)
        torch.cuda.synchronize()
        mesh.stats.reset()
        t0 = time.perf_counter()
        for _ in range(TP_TIMED_STEPS):
            _, local = serve(mine, nxt, local)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TP_TIMED_STEPS * 1e3
        st = mesh.stats.to_dict()
        per = {"calls": {k: v / TP_TIMED_STEPS for k, v in
                         st["calls"].items()},
               "bytes": {k: v // TP_TIMED_STEPS for k, v in
                         st["bytes"].items()},
               "staged_bytes": st["staged_bytes"] // TP_TIMED_STEPS}
        return dt, per

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run_ranks((1, 2), fn, backend="gloo", device=dev)
    dev_ms = sum(_device_us(e) for e in prof.key_averages()) / 1e3 / (
        TP_TIMED_STEPS + 2)
    check(dev_ms > 0, "the 2-rank serve steps' trace holds no device time")
    return (max(o[0] for o in out), dev_ms, out[0][1],
            _kernel_split(prof, TP_TIMED_STEPS + 2))


def tp_gemma(ops, ref, dev, model, params, phase="phase 18a"):
    """18a, on phase 3's full-width gemma-2b (bf16): a (1, 2) mesh of gloo
    thread ranks sharing the card -- 4 query heads a rank over the one
    KV head, the MLP hidden dim and the vocabulary split -- prefills
    MESH_PROMPTS and decodes MESH_STEPS steps against the one-device
    steps (TP_LOGIT_TOL, equal greedy tokens), #1 counted on each rank
    and held against its plain version at G 4; the TP step's wall and
    device time beside the one-device step's, with its collectives; then
    reduced float32 gemma-2b within F32_LOGIT_TOL, which a planted fault
    (the ranks' ``wo`` pieces swapped) must exceed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    L = model.cfg.num_layers
    rec = Recorder(ops, ("paged_attention_append",))
    rel, same, launches, res, one, fed, ca = _tp_against_one(
        model, params, dev, MESH_B, MESH_PROMPTS, 29, record=rec)
    per_rank = [c["paged_attention_append"] for c in launches]
    (q, *_), _ = rec.last["paged_attention_append"]
    G = q.shape[2]
    log(f"{phase}: 2 gloo ranks on one card, full-width gemma-2b bf16 over "
        f"the model axis (4 query heads a rank over the 1 KV head, MLP "
        f"{model.cfg.d_ff // 2} and vocabulary {model.cfg.vocab_size // 2} "
        f"a rank), B {MESH_B}: gathered logits vs the one-device steps "
        f"{rel:.4e} of max |logit| (tol {TP_LOGIT_TOL}) over the prefill "
        f"and {MESH_STEPS} steps, greedy tokens "
        f"{'equal' if same else 'DIFFERENT'}; #1 launched {per_rank} times "
        f"by the ranks at G {G} ({CARD})")
    check(rel <= TP_LOGIT_TOL and same, f"{phase}: the tensor-parallel "
          f"steps differ from the one-device steps: {rel:.4e}")
    check(per_rank == [MESH_STEPS * L] * 2 and G == 4,
          f"{phase}: #1 launches per rank {per_rank} at G {G}")
    measure_append(ops, ref, rec.last,
                   {"paged_attention_append": per_rank[0]}, phase)
    del rec
    nxt = fed[-1]
    wall, dev_ms, per, split = _tp_timed(model, dev, res, nxt)
    t_one = time_ms(lambda: model.decode_step(params, nxt, ca), iters=10,
                    warmup=2, tries=STEP_TRIES)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(TP_TIMED_STEPS):
            model.decode_step(params, nxt, ca)
        torch.cuda.synchronize()
    one_split = _kernel_split(prof, TP_TIMED_STEPS)
    log(f"{phase}: a serve step of B {MESH_B}: one device {t_one[1]:.3f} ms "
        f"wall / {t_one[0]:.3f} ms device; 2 ranks over the model axis "
        f"{wall:.3f} ms wall / {dev_ms:.3f} ms of device time (both "
        f"ranks' kernels and staging copies, the card shared); rank 0's "
        f"collectives a step {per} ({CARD})")
    log(f"{phase}: device ms a step by kernel, 2 ranks: {split[0]}, "
        f"heaviest {split[1]}; one device: {one_split[0]}, heaviest "
        f"{one_split[1]}")
    del res, one, ca
    cfg = get_config("gemma_2b").reduced()
    rm = build_model(cfg)
    rp = rm.init(seed=3, device=dev)
    gaps = {}
    for fault in (None, _swap_wo):
        g, same, _, _, _, _, _ = _tp_against_one(
            rm, rp, dev, 4, (24, 13, 7, 24), 5, fault)
        gaps[fault is not None] = g
    log(f"{phase}: 2 gloo ranks, reduced float32 gemma-2b, B 4 over the "
        f"model axis: gathered logits vs one device {gaps[False]:.3e} of "
        f"max |logit| (tol {F32_LOGIT_TOL}); planted fault (the ranks' "
        f"attention wo pieces swapped) {gaps[True]:.3e}")
    check(gaps[False] <= F32_LOGIT_TOL, f"{phase}: reduced tensor-parallel "
          f"logits differ: {gaps[False]:.3e}")
    check(gaps[True] > F32_LOGIT_TOL, f"{phase}: the planted wo fault stays "
          f"within the limit: {gaps[True]:.3e}")


def _tp_layer(mesh, cfg, lp, x):
    """One MoE layer's output on this rank's pieces of ``lp`` (the
    model's placements for ``cfg``) and its collectives."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models.api import build_model
    from repro_torch.models.moe_sharded import moe_ffn_dispatch

    spec = STEPS.param_placements(build_model(cfg), mesh)["layers"]["ff"]
    mine = {k: SH.local_piece(mesh, v, spec[k][1:]) for k, v in lp.items()}
    with SH.use_rules(mesh), torch.no_grad():
        y = moe_ffn_dispatch(mine, x[None], cfg)[0]
    torch.cuda.synchronize()
    return y, mesh.stats.to_dict()


def _near_ties(got, one):
    """The (step, row) pairs whose greedy token differs between the mesh
    logits ``got`` and the one-device logits ``one``, each with the
    one-device top-2 margin as a fraction of its step's max |logit|."""
    out = []
    for i, (a, b) in enumerate(zip(got, one)):
        top = b.float().topk(2, dim=-1).values
        scale = float(b.float().abs().max())
        for r in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten():
            out.append((i, int(r),
                        float(top[r, 0] - top[r, 1]) / scale))
    return out


def tp_moe_served(model, params, dev, phase="phase 18b"):
    """18b's bf16 reading on Qwen3-30B-A3B's served weights (full width,
    the first TP_SERVED_DEPTH of its 48 layers, as views, to leave
    time for phase 19): the (1, 2) mesh's ``tp`` prefill and decode steps
    against the one-device steps -- each rank's row-parallel and expert
    partial sums float32, rounded once, where one device rounds each
    expert's output, each weighted replica and each add of the combine.
    The
    gate is LOGIT_TOL, the one phase 8 holds the one-device kernel and
    plain paths to in bf16 at full depth: there a rounding difference
    flips routing choices (``routing_gaps``), and so it does here.
    Greedy tokens must agree except at a near tie: a row whose
    one-device top-2 margin is within the measured gap."""
    model, params = _cut(model, params, TP_SERVED_DEPTH)
    cfg, L = model.cfg, model.cfg.num_layers
    rel, _, launches, res, one, _, _ = _tp_against_one(
        model, params, dev, TP_B, TP_PROMPTS, 43)
    ties = _near_ties(res[0][0], one)
    del res, one
    per_rank = [c["paged_attention_append"] for c in launches]
    log(f"{phase}: 2 gloo ranks, {cfg.name}'s served weights ({cfg.dtype}, "
        f"the first {L} layers), tp layout, B {TP_B}: gathered logits vs the "
        f"one-device steps {rel:.4e} of max |logit| (tol {LOGIT_TOL}), "
        f"greedy tokens differ at {len(ties)} of {TP_B * (MESH_STEPS + 1)} "
        f"(step, row, one-device top-2 margin of max |logit|): {ties}; #1 "
        f"launched {per_rank} times by the ranks ({CARD})")
    check(rel <= LOGIT_TOL and all(m <= rel for _, _, m in ties),
          f"{phase}: bf16 tp steps differ from the one-device steps: "
          f"{rel:.4e}, tokens {ties}")
    check(per_rank == [MESH_STEPS * L] * 2,
          f"{phase}: #1 launches per rank {per_rank}")


def tp_moe(ops, dev, m32, p32, phase="phase 18b"):
    """18b, on Qwen3-30B-A3B's float32 cut to 4 layers at published
    widths (phase 8's float32 step): the (1, 2) mesh's ``tp`` steps, and
    its ``ep`` steps at capacity_factor = E / top_k (nothing dropped),
    within F32_LOGIT_TOL of the one-device dropless steps; one MoE layer's
    ``ep`` exchange at the config's capacity within 1e-5 of
    ``moe_ep_local`` at decode and prefill token counts, the dropped
    replicas counted; the bytes of the layer's all-to-all against the
    ``tp`` layout's all-reduce."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.api import build_model
    from repro_torch.models.lm import layer_params
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_sharded import ep_dropped, moe_ep_local

    cfg = m32.cfg
    rel, same, launches, res, _, _, _ = _tp_against_one(
        m32, p32, dev, TP_B, TP_PROMPTS, 31)
    del res
    per_rank = [c["paged_attention_append"] for c in launches]
    log(f"{phase}: 2 gloo ranks, full-width {cfg.name} cut to "
        f"{cfg.num_layers} layers in float32, tp layout (expert hidden dim "
        f"{cfg.moe.d_ff_expert // 2} a rank, {cfg.num_heads // 2} query "
        f"heads over {cfg.kv_heads // 2} KV heads a rank), B {TP_B}: "
        f"gathered logits vs the one-device dropless steps {rel:.3e} of max "
        f"|logit| (tol {F32_LOGIT_TOL}), greedy tokens "
        f"{'equal' if same else 'DIFFERENT'}; #1 launched {per_rank} times "
        f"by the ranks at G {cfg.num_heads // cfg.kv_heads}")
    check(rel <= F32_LOGIT_TOL and same, f"{phase}: tp steps differ: "
          f"{rel:.3e}")
    check(per_rank == [MESH_STEPS * cfg.num_layers] * 2,
          f"{phase}: #1 launches per rank {per_rank}")
    # a token picks an expert at most once, so no expert gets more than T
    # replicas: cap = E / k gives C = int(T k cap) // E + 1 = T + 1 slots,
    # which drop nothing, in 1/k of the buffers cap = E would take
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    m_ep = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, parallel_mode="ep", capacity_factor=E / k)))
    rel, same, launches, res, _, _, _ = _tp_against_one(
        m_ep, p32, dev, TP_B, TP_PROMPTS, 31)
    a2a = [r[4]["calls"].get("all_to_all", 0) for r in res]
    del res
    log(f"{phase}: 2 gloo ranks, the same cut, ep layout ({E // 2} experts "
        f"a rank, capacity_factor {E / k:g}: C = T + 1, nothing dropped) "
        f"through the mesh prefill and serve steps, B {TP_B}: "
        f"gathered logits vs the one-device dropless steps {rel:.3e} of "
        f"max |logit| (tol {F32_LOGIT_TOL}), greedy tokens "
        f"{'equal' if same else 'DIFFERENT'}; all-to-alls a rank {a2a}")
    check(rel <= F32_LOGIT_TOL and same, f"{phase}: ep steps differ: "
          f"{rel:.3e}")
    check(min(a2a) == 2 * cfg.num_layers * (MESH_STEPS + 1),
          f"{phase}: ep all-to-alls a rank {a2a}")
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, parallel_mode="ep"))
    lp = layer_params(p32["layers"], 0)["ff"]
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    drops = 0
    for T in (TP_B, TP_B * TP_WIDTH):
        x = torch.randn((T, cfg.d_model), generator=g, device=dev)
        want = moe_ep_local(lp, x, ep)
        dropped = ep_dropped(lp, x, ep)
        drops += dropped
        out = {}
        for c in (ep, cfg):
            out[c.moe.parallel_mode] = run_ranks(
                (1, 2), lambda m, c=c: _tp_layer(m, c, lp, x),
                backend="gloo", device=dev)
        gap = max_err(out["ep"][0][0], want) / float(want.abs().max())
        dropless = moe_ffn(lp, x, cfg)
        tgap = max_err(out["tp"][0][0], dropless) / float(
            dropless.abs().max())
        a2a = out["ep"][0][1]["bytes"].get("all_to_all", 0)
        ar = out["tp"][0][1]["bytes"].get("all_reduce", 0)
        k, d = cfg.moe.top_k, cfg.d_model
        log(f"{phase}: one MoE layer over T {T} tokens on 2 ranks: ep "
            f"({cfg.moe.num_experts // 2} experts a rank, capacity "
            f"{int(T * k * 1.25) // cfg.moe.num_experts + 1} an expert, "
            f"{dropped} of {T * k} replicas dropped) vs moe_ep_local "
            f"{gap:.3e} of max |y| (tol {F32_LOGIT_TOL}); tp vs the "
            f"dropless layer {tgap:.3e}; bytes a rank hands in: ep "
            f"all-to-all {a2a} ({a2a / T:.0f} B a token, two exchanges of "
            f"the padded capacity buffers), tp all-reduce {ar} "
            f"({ar / T:.0f} B a token); the reference's claim: top_k * d = "
            f"{k * d * 4} B against d = {d * 4} B a token in float32")
        check(gap <= F32_LOGIT_TOL and tgap <= F32_LOGIT_TOL,
              f"{phase}: the MoE layouts differ: ep {gap:.3e} tp {tgap:.3e}")
    check(drops > 0, f"{phase}: the ep layer dropped no replica, so the "
          f"capacity rule went unchecked")


def tp_mla(ops, ref, dev, m32, p32, phase="phase 18c"):
    """18c, on DeepSeek-V2-Lite's float32 cut to 4 layers at published
    widths (phase 9's float32 step): MLA heads split over a (1, 2) mesh
    (#7 at G 8 on each rank, held against its plain version), the shared
    experts and the leading dense layer, within F32_LOGIT_TOL of the
    one-device steps."""
    cfg = m32.cfg
    rec = Recorder(ops, ("paged_attention",))
    rel, same, launches, res, _, _, _ = _tp_against_one(
        m32, p32, dev, TP_B, TP_PROMPTS, 37, record=rec)
    per_rank = [c["paged_attention"] for c in launches]
    (q, *_), _ = rec.last["paged_attention"]
    log(f"{phase}: 2 gloo ranks, full-width {cfg.name} cut to "
        f"{cfg.num_layers} layers in float32 ({cfg.num_heads // 2} MLA "
        f"heads a rank, the latent pool replicated; tp experts, shared "
        f"experts and the leading dense MLP split), B {TP_B}: gathered "
        f"logits vs the one-device steps {rel:.3e} of max |logit| (tol "
        f"{F32_LOGIT_TOL}), greedy tokens {'equal' if same else 'DIFFERENT'}"
        f"; #7 launched {per_rank} times by the ranks at G {q.shape[2]}")
    check(rel <= F32_LOGIT_TOL and same, f"{phase}: MLA tp steps differ: "
          f"{rel:.3e}")
    check(per_rank == [MESH_STEPS * cfg.num_layers] * 2 and
          q.shape[2] == cfg.num_heads // 2,
          f"{phase}: #7 launches per rank {per_rank} at G {q.shape[2]}")
    measure_latent(ops, ref, rec.last, {"paged_attention": per_rank[0]},
                   phase)
    del res, rec


def model_axis_path(ops, ref, dev, model, params):
    """Phase 18a on phase 3's full-width weights; alone: import
    ``chip_smoke``, set ``CARD``, build a full-width gemma-2b and call
    ``chip_smoke.model_axis_path(ops, ref, dev, model, params)``.  18b and
    18c run inside phases 8 and 9 (``tp_moe``, ``tp_mla`` on the float32
    cuts ``_cut(model, params, F32_DEPTH, torch.float32)`` gives)."""
    t0 = time.perf_counter()
    tp_gemma(ops, ref, dev, model, params)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18a: {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 20: the constant-state families over the model axis
# ---------------------------------------------------------------------------
#: layers of 20a's and 20b's bf16 readings on the served weights (views;
#: Zamba2's first two groups)
TP_STATE_DEPTH = 12
#: how much farther from the float32 one-device steps the bf16 mesh
#: steps of 20a and 20b may lie than the bf16 one-device steps do, of max
#: |logit|: ~3.6x RWKV6's 1.4e-03 on an H100 (2.3198e-02 against
#: 2.1798e-02); Zamba2's mesh lies 1.6e-04 nearer
TP_STATE_EXCESS = 5e-3
#: layers of 20c's float32 training cuts
TP_STATE_F32 = {"zamba2_2p7b": 12, "rwkv6_7b": 2, "mamba2_370m": 2}


def _state_cut(model, params, depth, dtype=None):
    """A constant-state model on its first ``depth`` layers (Zamba2:
    whole groups, each with its LoRA), with its weights in ``dtype``
    (None: views of the served weights)."""
    from repro_torch.models.api import build_model

    cfg = model.cfg
    per = cfg.shared_attn_every
    n = depth // per if per else depth
    stacked = ("mamba_layers", "lora") if per else ("layers",)

    def cast(tree, cut):
        if isinstance(tree, dict):
            return {k: cast(v, cut) for k, v in tree.items()}
        t = tree[:n] if cut else tree
        return t if dtype is None else t.to(dtype)

    out = {k: cast(v, k in stacked) for k, v in params.items()}
    cfg = dataclasses.replace(cfg, num_layers=depth, dtype=str(
        dtype or cfg.torch_dtype).replace("torch.", ""))
    return build_model(cfg), out


def _local_sum_squares(x):
    """The planted norm fault: a rank's own sum of squares, the model
    axis's sum left out."""
    xf = x.float()
    return (xf * xf).sum(dim=-1, keepdim=True)


def _plant_norm_fault():
    """Plant the norm fault (the norms over the heads take a rank's own
    sum of squares) for every rank of this process; returns the undo."""
    from repro_torch.launch import shardings as SH

    real = SH.model_sum_squares
    SH.model_sum_squares = _local_sum_squares
    return lambda: setattr(SH, "model_sum_squares", real)


def tp_state_served(ops, ref, dev, model, params, phase):
    """20a (inside phase 11, Zamba2-2.7B, on its served weights) or 20b
    (inside phase 12, RWKV6-7B): a (1, 2) mesh of gloo thread ranks
    sharing the card -- the SSM heads, the hybrid's attention heads and
    MLP, the vocabulary split, the norms over the heads summed over the
    ranks -- prefills TP_PROMPTS and decodes MESH_STEPS steps on the
    first TP_STATE_DEPTH layers (views) against the one-device steps,
    greedy tokens equal except at a near tie (18b's rule).  The same
    layers in float32 (one device, fed the same tokens) measure what
    bf16 costs: the mesh's bf16 logits may lie at most TP_STATE_EXCESS
    farther from them than the one-device bf16 logits do, and the
    hybrid's also within TP_LOGIT_TOL of the one-device bf16 steps
    (RWKV6's recurrence compounds bf16 rounding flips past it: 2.1484e-02
    of max |logit| on an H100, every token equal).  A token may differ
    only where the one-device top-2 margin is within both the measured
    gap and TP_LOGIT_TOL.  For the hybrid #1 is
    counted on each rank, once per group a step, and held against its
    plain version at the rank's KVH 16, G 1, HD 80.  Then the float32
    layers on the mesh within F32_LOGIT_TOL of one device, which the
    planted fault (the norms' model-axis sum of squares left out) must
    exceed."""
    cfg = model.cfg
    name = cfg.name
    hybrid = hasattr(model, "kv_config")
    m, p = _state_cut(model, params, TP_STATE_DEPTH)
    rec = Recorder(ops, ("paged_attention_append",)) if hybrid else None
    rel, _, launches, res, one, fed, _ = _tp_against_one(
        m, p, dev, TP_B, TP_PROMPTS, 47, record=rec)
    ties = _near_ties(res[0][0], one)
    got, stats = res[0][0], res[0][4]
    del res
    per_rank = [c.get("paged_attention_append", 0) for c in launches]
    if hybrid:
        (q, *_), _ = rec.last["paged_attention_append"]
        shape = tuple(q.shape[1:])
        want = (cfg.kv_heads // 2, cfg.num_heads // cfg.kv_heads, cfg.hd)
        check(per_rank == [MESH_STEPS * m.groups] * 2 and shape == want,
              f"{phase}: #1 launches per rank {per_rank} at (KVH, G, HD) "
              f"{shape}, want {want}")
        measure_append(ops, ref, rec.last,
                       {"paged_attention_append": per_rank[0]}, phase)
    else:
        check(per_rank == [0, 0], f"{phase}: a kernel launched: {per_rank}")
    del rec, m, p
    m32, p32 = _state_cut(model, params, TP_STATE_DEPTH, torch.float32)
    gaps = {}
    for fault in (False, True):
        g, same, _, _, one32, _, _ = _tp_against_one(
            m32, p32, dev, TP_B, TP_PROMPTS, 47, feed=fed,
            planted=_plant_norm_fault if fault else None)
        gaps[fault] = (g, same)
    d_one, _ = _tp_gap(one, one32)
    d_tp, _ = _tp_gap(got, one32)
    del one, one32, got
    log(f"{phase}: 2 gloo ranks on one card, {name}'s served weights "
        f"({cfg.dtype}, the first {TP_STATE_DEPTH} of {cfg.num_layers} "
        f"layers) over the model axis, B {TP_B}: gathered logits vs the "
        f"one-device steps {rel:.4e} of max |logit| over the prefill and "
        f"{MESH_STEPS} steps; from the float32 one-device steps (same "
        f"layers, same tokens) the mesh {d_tp:.4e}, one device "
        f"{d_one:.4e} (tol: {TP_STATE_EXCESS} more"
        f"{f', and {TP_LOGIT_TOL} between the two' if hybrid else ''}); "
        f"greedy tokens differ at {len(ties)} of {TP_B * (MESH_STEPS + 1)} "
        f"(step, row, one-device top-2 margin of max |logit|): {ties}; #1 "
        f"launched {per_rank} times by the ranks; rank 0's collectives "
        f"{stats['calls']}, {stats['staged_bytes']} B staged ({CARD})")
    check(d_tp <= d_one + TP_STATE_EXCESS
          and (rel <= TP_LOGIT_TOL or not hybrid)
          and all(mg <= min(rel, TP_LOGIT_TOL) for _, _, mg in ties),
          f"{phase}: the tensor-parallel steps differ from the one-device "
          f"steps: {rel:.4e} (from float32 {d_tp:.4e} against "
          f"{d_one:.4e}), tokens {ties}")
    log(f"{phase}: 2 gloo ranks, the same layers in float32, B {TP_B}: "
        f"gathered logits vs one device {gaps[False][0]:.3e} of max "
        f"|logit| (tol {F32_LOGIT_TOL}), greedy tokens "
        f"{'equal' if gaps[False][1] else 'DIFFERENT'}; planted fault (the "
        f"norms over the heads without their model-axis sum of squares) "
        f"{gaps[True][0]:.3e}")
    check(gaps[False][0] <= F32_LOGIT_TOL and gaps[False][1],
          f"{phase}: float32 tensor-parallel logits differ: "
          f"{gaps[False][0]:.3e}")
    check(gaps[True][0] > F32_LOGIT_TOL, f"{phase}: the planted norm fault "
          f"stays within the limit: {gaps[True][0]:.3e}")
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: training over the model axis, ranks as processes sharing the card
# ---------------------------------------------------------------------------
TP_TRAIN_STEPS = 2                 # 19a's launcher steps
TP_TRAIN_TOL = 2e-2                # the reference's parity test's limits
TP_TRAIN_DEADLINE = 240.0          # s, 19a's torchrun
TP_CUT_TOL = 1e-5                  # 19b / 19c: relative, and of a leaf's max
TP_CUT_OPT = dict(lr_peak=1.0, warmup_steps=1, eps=1.0, weight_decay=0.0)
TP_QWEN_CUT = 2                    # layers of 19c's float32 Qwen3 cut


def tp_train_launcher(dev, phase="phase 19a"):
    """19a: ``torchrun --standalone --nproc_per_node 2 -m
    repro_torch.launch.train --model-parallel 2 --device cuda:0`` on
    full-width gemma-2b in bf16 with phase 14's seed, data, B and S
    (``remat``, sequence parallelism on): two processes over gloo share
    the card.  Their first step's loss and clip norm must lie within
    TP_TRAIN_TOL (the norm's times max(1, norm)) of phase 14's first
    one-device step (``TRAIN_FIRST``); each step's wall time and each
    rank's collectives, staged bytes and peak memory are logged."""
    import shutil
    import signal
    import tempfile

    check(TRAIN_FIRST is not None, f"{phase}: phase 14's first step was "
          f"not recorded")
    tmp = tempfile.mkdtemp(dir=ROOT, prefix=".phase19-")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [q for q in [env.get("PYTHONPATH")] if q])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
           "--arch", "gemma_2b", "--model-parallel", "2", "--device",
           "cuda:0", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
           "--seed", "0", "--steps", str(TP_TRAIN_STEPS), "--log-every",
           "1", "--ckpt-every", "0", "--ckpt-dir", tmp]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TP_TRAIN_DEADLINE)
    except subprocess.TimeoutExpired:
        # torchrun passes SIGTERM on to its workers and waits for them
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        check(False, f"{phase}: torchrun ran past {TP_TRAIN_DEADLINE} s: "
              f"{err[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{phase}: torchrun exited with "
          f"{proc.returncode}: {err[-3000:]}")
    steps = [(float(a), float(b), float(c)) for a, b, c in re.findall(
        r"\] loss=([-0-9.naif]+) grad_norm=([-0-9.naif]+) dt=([0-9.]+)ms",
        out)]
    ranks = re.findall(r"^(?:\S*: ?)?(rank \d: .*)$", out, re.M)
    for line in re.findall(r"^(?:\S*: ?)?(mesh \{.*)$", out, re.M):
        log(f"{phase}: {line}")
    for line in ranks + re.findall(r"^(?:\S*: ?)?(rank 0's collectives.*)$",
                                   out, re.M):
        log(f"{phase}: {line} ({CARD})")
    check(len(steps) == TP_TRAIN_STEPS and len(ranks) == 2,
          f"{phase}: the launcher printed {len(steps)} steps and "
          f"{len(ranks)} rank lines: {out[-3000:]}")
    loss1, gn1 = TRAIN_FIRST
    (loss, gn, _), losses = steps[0], [x[0] for x in steps]
    log(f"{phase}: 2 processes sharing the card over gloo, full-width "
        f"gemma-2b bf16 at tp 2 (sequence parallelism, remat), B {TRAIN_B} "
        f"S {TRAIN_S}: losses {losses}, clip norms "
        f"{[x[1] for x in steps]}, step walls (ms) {[x[2] for x in steps]}; "
        f"first step vs phase 14's one-device step: loss {loss:.6f} vs "
        f"{loss1:.6f} (gap {abs(loss - loss1):.3e}, tol {TP_TRAIN_TOL}), "
        f"clip norm {gn:.6f} vs {gn1:.6f} (gap {abs(gn - gn1):.3e}, tol "
        f"{TP_TRAIN_TOL * max(1.0, gn1):.3e}); torchrun {wall:.1f} s "
        f"({CARD})")
    check(all(np.isfinite(losses)) and abs(loss - loss1) <= TP_TRAIN_TOL
          and abs(gn - gn1) <= TP_TRAIN_TOL * max(1.0, gn1),
          f"{phase}: the tp 2 step differs from the one-device step: loss "
          f"{loss} vs {loss1}, clip norm {gn} vs {gn1}")


def _plant_gather_fault():
    """The planted fault: this process's first column-parallel input in
    the backward pass keeps its own share of the gradient, the sum over
    the model axis left out.  Returns the undo."""
    from repro_torch.launch import shardings as SH

    real = SH._GatherSeq.backward
    done = []

    def faulty(ctx, g):
        if done:
            return real(ctx, g)
        done.append(True)
        n = g.shape[ctx.dim] // ctx.mesh.shape["model"]
        return (g.narrow(ctx.dim, ctx.mesh.axis_index("model") * n,
                         n).contiguous(), None, None)

    SH._GatherSeq.backward = staticmethod(faulty)
    return lambda: setattr(SH._GatherSeq, "backward", staticmethod(real))


def tp_cut_rank(cuts, go, mesh):
    """One process rank of 19b, 19c, 20c and 21c: ``cuts`` is [(label,
    runs, batch, together)], ``runs`` [(name, config, rules, fault)]
    (fault: False, or the planted fault: ``"gather"``, ``"norm"``,
    ``"cross"`` or ``"prefix"``), a cut's
    configs all the same weights (seed 0) in float32.  The rank first
    takes the training path's one-time host costs (the first
    ``torch.utils.checkpoint`` call imports the compiler stack, seconds
    in a fresh process), then waits for the file ``go`` (19a's end).
    For each cut every rank takes the one-device step
    (``build_train_step`` on the whole weights) -- all at once with
    ``together``, else in turns, one whole step on the card at a time --
    and keeps its updated weights; then each run's mesh train step on
    this rank's pieces.
    Returns, by cut and run, the loss, clip norm, the worst leaf's gap
    (this rank's updated pieces against the same pieces of the
    one-device step's leaves, over each leaf's max), the step's wall
    ms, this rank's collectives and staged bytes; the one-device
    reading; and the wall-clock time (``time.time()``) at which each
    stage ended."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import flatten_with_paths

    from torch.utils.checkpoint import checkpoint

    times = [("start", time.time())]
    x = torch.ones(1, requires_grad=True)
    checkpoint(lambda a: a * 2, x, use_reentrant=False).backward()
    times.append(("warm", time.time()))
    end = time.time() + TP_TRAIN_DEADLINE + 60
    while not os.path.exists(go):
        if time.time() > end:
            raise TimeoutError(f"no go signal ({go}) by the deadline")
        time.sleep(0.05)
    times.append(("go", time.time()))
    dev = mesh.device
    free = torch.cuda.mem_get_info(dev)[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    ocfg = OPT.AdamWConfig(**TP_CUT_OPT)
    results = {}
    for label, runs, batch, together in cuts:
        steps = {name: STEPS.build_train_step(build_model(c), ocfg,
                                              mesh=mesh, rules=rules)
                 for name, c, rules, _ in runs}
        times.append((f"{label}: steps built", time.time()))
        for turn in range(1 if together else mesh.size):
            if together or turn == mesh.rank:
                model = build_model(runs[0][1])
                ref = model.init(seed=0, device=dev)
                one = STEPS.build_train_step(model, ocfg, device=dev)
                torch.cuda.synchronize()
                times.append((f"{label}: weights drawn", time.time()))
                t0 = time.perf_counter()
                ref, _, m = one(ref, OPT.init_state(ref), batch)
                reading = (float(m["loss"]), float(m["grad_norm"]),
                           (time.perf_counter() - t0) * 1e3)
                del m
                gc.collect()
                # the same seed's weights again, cut into this rank's
                # pieces once the step's gradients and moments are gone
                whole = model.init(seed=0, device=dev)
                pieces = {name: STEPS.shard_params(
                    mesh, whole, steps[name].in_shardings[0], copy=True)
                    for name, *_ in runs}
                del whole
                gc.collect()
                torch.cuda.empty_cache()
            mesh.barrier()
        times.append((f"{label}: one-device steps", time.time()))
        paths, ref_leaves, _ = flatten_with_paths(ref)
        out = {"one": reading}
        for name, _, _, fault in runs:
            step = steps[name]
            pshard, oshard = step.in_shardings
            p = pieces.pop(name)
            o = STEPS.init_opt_state(mesh, p, oshard)
            undo = ({"gather": _plant_gather_fault,
                     "norm": _plant_norm_fault,
                     "cross": _plant_cross_fault,
                     "prefix": _plant_prefix_fault}[fault]() if fault
                    else None)
            mesh.stats.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                p, o, m = step(p, o, STEPS.shard_batch(mesh, batch))
                loss, gn = float(m["loss"]), float(m["grad_norm"])
            finally:
                if undo is not None:
                    undo()
            wall = (time.perf_counter() - t0) * 1e3
            stats = mesh.stats.to_dict()
            gaps = []
            with torch.no_grad():
                for pth, t, w, spec in zip(paths, flatten_with_paths(p)[1],
                                           ref_leaves,
                                           SH.spec_leaves(pshard)):
                    want = SH.local_piece(mesh, w, spec)
                    gaps.append((float((t - want).abs().max())
                                 / max(float(w.abs().max()), 1e-30), pth))
            out[name] = {"loss": loss, "gnorm": gn, "gap": max(gaps),
                         "wall_ms": wall, "stats": stats,
                         "peak": torch.cuda.max_memory_allocated(dev)}
            del p, o, m
            gc.collect()
            torch.cuda.empty_cache()
        times.append((f"{label}: mesh steps", time.time()))
        del ref, ref_leaves, steps
        gc.collect()
        torch.cuda.empty_cache()
        results[label] = out
    results["times"] = times
    results["free_at_start"] = free
    return results


def _tp_cut_log(phase, what, res, fault=None, tol=TP_CUT_TOL):
    """Log and gate one cut of 19b, 19c, 20c or 21c (``tp_cut_rank``'s
    results of both ranks for it): the loss and the clip norm within
    ``tol`` relative, the worst leaf within TP_CUT_TOL of its max."""
    one = res[0]["one"]
    log(f"{phase}: {what}: the one-device step (each rank's own) loss "
        f"{one[0]:.6f}, clip norm {one[1]:.6f}, {one[2]:.1f} ms; rank 1's "
        f"{'equal' if res[1]['one'][:2] == one[:2] else 'DIFFERENT'} "
        f"({CARD})")
    for name in [k for k in res[0] if k != "one"]:
        r0 = res[0][name]
        lg = abs(r0["loss"] - one[0]) / abs(one[0])
        gg = abs(r0["gnorm"] - one[1]) / one[1]
        gap = max(r[name]["gap"] for r in res)
        st = [r[name]["stats"] for r in res]
        log(f"{phase}: {what}, {name}: loss {r0['loss']:.6f} (rel gap "
            f"{lg:.3e}), clip norm {r0['gnorm']:.6f} (rel gap {gg:.3e}), "
            f"worst leaf after one AdamW step {gap[0]:.3e} of its max "
            f"({gap[1]}; tol {TP_CUT_TOL}; loss and norm {tol}); step wall "
            f"{[round(r[name]['wall_ms'], 1) for r in res]} ms; a rank's "
            f"collectives {st[0]['calls']}, {sum(st[0]['bytes'].values())} "
            f"B handed in, {st[0]['staged_bytes']} B staged, "
            f"{sum(st[0]['seconds'].values()) * 1e3:.1f} ms in them; peak "
            f"{[round(r[name]['peak'] / 2**30, 2) for r in res]} GiB "
            f"({CARD})")
        agree = lg <= tol and gg <= tol and gap[0] <= TP_CUT_TOL
        if name == fault:
            check(not agree, f"{phase}: {what}: the planted fault lies "
                  f"within the limit ({gap[0]:.3e})")
        else:
            check(agree and all(r[name]["loss"] == r0["loss"] for r in res),
                  f"{phase}: {what}, {name}: the tp step differs from the "
                  f"one-device step: loss {lg:.3e}, norm {gg:.3e}, leaf "
                  f"{gap}")


def tp_train_cuts(go):
    """19b, 19c and 20c in one ``spawn_ranks`` call (two processes
    sharing the card over gloo, (1, 2)), the ranks waiting for the file
    ``go`` before they take the card: phase 14's two-layer full-width
    float32 gemma-2b cut at tp 2 with sequence parallelism on and off and
    with the planted fault, Qwen3-30B-A3B's published widths cut to
    TP_QWEN_CUT layers in float32 in the ``tp`` and ``ep`` layouts (``ep``
    at capacity_factor E / top_k: C = T + 1, nothing dropped), and 20c:
    Mamba2-370M, RWKV6-7B and Zamba2-2.7B (two groups, two LoRAs) at
    their published widths cut to ``TP_STATE_F32`` layers in float32,
    SSM heads split, sequence parallelism on, Mamba2's with the planted
    norm fault too; and 21c: Whisper-tiny whole and InternVL2-1B cut to
    TP_VLM_CUT layers, at published widths in float32 (B 2, 64 text
    tokens over 1500 frames or after 256 image tokens, sequence
    parallelism on), each with its planted fault (the cross attention's
    ``wo`` unsummed; the image-prefixed piece without its gather).
    Returns the ranks' results and the call's start (wall clock)."""
    import functools

    import chip_smoke
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import spawn_ranks

    gcfg = dataclasses.replace(full_width_config(), num_layers=TRAIN_CUT,
                               dtype="float32")
    qcfg = dataclasses.replace(qwen3_config(), num_layers=TP_QWEN_CUT,
                               dtype="float32")
    e = qcfg.moe
    qep = dataclasses.replace(qcfg, moe=dataclasses.replace(
        e, parallel_mode="ep", capacity_factor=e.num_experts / e.top_k))

    def batch_for(cfg):
        b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=1, seed=0)).batch_at(0)
        b["targets"] = b["targets"].copy()
        b["targets"][:, ::5] = -1
        return b

    # 20c: the constant-state families cut at their published widths
    state = {a: dataclasses.replace(state_config(a),
                                    num_layers=TP_STATE_F32[a],
                                    dtype="float32")
             for a in TP_STATE_F32}
    # the ranks take the gemma cut's one-device steps at once (~15 GB a
    # rank), Qwen3's in turns (~35 GB a rank), then Mamba2's and Zamba2's
    # at once (~1 and ~12 GB) and RWKV6's in turns (~20 GB)
    cuts = [("19b", [("sequence parallel", gcfg, None, False),
                     ("plain Megatron", gcfg, {"seq": None}, False),
                     ("fault", gcfg, None, "gather")], batch_for(gcfg), True),
            ("19c", [("tp", qcfg, None, False), ("ep", qep, None, False)],
             batch_for(qcfg), False)]
    cuts += [(f"20c {a}", [("sequence parallel", c, None, False)]
              + ([("norm fault", c, None, "norm")] if a == "mamba2_370m"
                 else []), batch_for(c), a != "rwkv6_7b")
             for a, c in state.items()]
    # 21c: Whisper-tiny whole and InternVL2-1B cut, each with its fault
    enc = {"whisper_tiny": (dataclasses.replace(
        get_config("whisper_tiny"), dtype="float32"), "cross"),
        "internvl2_1b": (dataclasses.replace(
            get_config("internvl2_1b"), num_layers=TP_VLM_CUT,
            dtype="float32"), "prefix")}
    cuts += [(f"21c {a}", [("sequence parallel", c, None, False),
                           (f"{f} fault", c, None, f)],
              _encdec_cut_batch(c), True) for a, (c, f) in enc.items()]
    w0 = time.time()
    return spawn_ranks((1, 2), functools.partial(chip_smoke.tp_cut_rank,
                                                 cuts, str(go)),
                       device="cuda:0", deadline=TP_TRAIN_DEADLINE + 300.0
                       ), w0


def _tp_cuts_log(res, w0, t_go):
    """Log and gate 19b and 19c (``tp_train_cuts``'s results), with
    each rank's stages timed from the call's start."""
    _tp_cut_log("phase 19b", f"gemma-2b cut to {TRAIN_CUT} layers, "
                f"float32, B 1 S 64", [r["19b"] for r in res],
                fault="fault")
    _tp_cut_log("phase 19c", f"Qwen3-30B-A3B cut to {TP_QWEN_CUT} layers, "
                f"float32, B 1 S 64", [r["19c"] for r in res])
    for a, n in TP_STATE_F32.items():
        _tp_cut_log("phase 20c", f"{a} at published widths cut to {n} "
                    f"layers, float32, B 1 S 64", [r[f"20c {a}"] for r in res],
                    fault="norm fault")
    for a, (what, f) in {
            "whisper_tiny": ("whole, 1500 frames", "cross fault"),
            "internvl2_1b": (f"cut to {TP_VLM_CUT} layers, 256 image tokens",
                             "prefix fault")}.items():
        _tp_cut_log("phase 21c", f"{a} at published widths, {what}, "
                    f"float32, B {TP_ENC_CUT_B} S {TP_ENC_CUT_S}",
                    [r[f"21c {a}"] for r in res], fault=f,
                    tol=TP_ENC_LOSS_TOL)
    times = res[0]["times"]
    first = next(i for i, (n, _) in enumerate(times) if n.startswith("21c"))
    log(f"phase 21c: {times[-1][1] - times[first - 1][1]:.1f} s on rank 0, "
        f"after 20c")
    log("phases 19b-19c, 20c and 21c (the ranks started beside 19a and waited "
        "for its end): " + "; ".join(
            f"rank {r}: " + ", ".join(f"{name} at {t - w0:.1f} s"
                                      for name, t in x["times"])
            for r, x in enumerate(res))
        + f"; after 19a's end {time.time() - t_go:.1f} s; the card had "
        f"{[round(x['free_at_start'] / 2**30, 2) for x in res]} GiB free "
        f"as the ranks began")


def _host_memory() -> str:
    """This process's resident set and the host's available memory, as
    /proc reports them."""
    def field(path, key):
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) / 2**20
        return float("nan")
    return (f"{field('/proc/self/status', 'VmRSS:'):.1f} GiB resident, "
            f"{field('/proc/meminfo', 'MemAvailable:'):.1f} GiB available")


def tp_train_path(dev):
    """Phase 19, right after phase 14; alone: import ``chip_smoke``, set
    ``CARD`` and ``TRAIN_FIRST`` (phase 14's first full-width step's loss
    and clip norm) and call ``chip_smoke.tp_train_path(dev)``.  The card
    is left to the ranks: this process frees its cached memory first.
    19b/19c's processes start with 19a's and wait for its end before
    they take the card."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    cached = torch.cuda.memory_reserved(dev) / 2**30
    log(f"phase 19: this process holds {held:.2f} GiB of the card "
        f"({cached:.2f} reserved); the card has {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free; host: {_host_memory()}")
    import tempfile
    import threading

    t0 = time.perf_counter()
    box = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase19-") as tmp:
        go = Path(tmp) / "go"

        def cuts():
            try:
                box["cuts"] = tp_train_cuts(go)
            except BaseException as e:       # raised below
                box["error"] = e

        # 19b/19c's processes start and warm up while 19a runs, and take
        # the card once it ends (also when it fails, so that they end)
        th = threading.Thread(target=cuts, name="phase19-cuts")
        th.start()
        try:
            tp_train_launcher(dev)
            mark_part("phase 19a")
        finally:
            go.touch()
            t_go = time.time()
            th.join()
    if "error" in box:
        raise box["error"]
    _tp_cuts_log(*box["cuts"], t_go)
    mark_part("phases 19c, 20c and 21c")
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 22: the cost account
# ---------------------------------------------------------------------------
def _accounts_equal(phase, what, card, meta):
    """The card's and meta's accounts of one step, exactly equal."""
    lines = {k: (v["launches"], v["bytes"], v["flops"], v["by_op"])
             for k, v in card.kernels.items()}
    mlines = {k: (v["launches"], v["bytes"], v["flops"], v["by_op"])
              for k, v in meta.kernels.items()}
    diff = {k: (card.by_op.get(k), meta.by_op.get(k))
            for k in set(card.by_op) | set(meta.by_op)
            if card.by_op.get(k) != meta.by_op.get(k)}
    check(card.flops == meta.flops and card.bytes == meta.bytes
          and not diff and lines == mlines and card.coll == meta.coll,
          f"{phase}: {what}'s account on meta differs from the card's: "
          f"FLOPs {card.flops} / {meta.flops}, bytes {card.bytes} / "
          f"{meta.bytes}, categories {diff}, kernels {lines} / {mlines}")


def _recorded(fn, inputs):
    """``fn()`` recorded with the peak tracker, ``inputs`` live from the
    start: (cost, the tracker's rise, the allocator's rise on a card)."""
    from repro_torch import cost
    from repro_torch.tree import leaves as tree_leaves

    on_card = any(t.device.type == "cuda" for t in tree_leaves(inputs)
                  if isinstance(t, torch.Tensor))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
    with cost.record(track_memory=True) as rec:
        rec.memory.see(t for t in tree_leaves(inputs)
                       if isinstance(t, torch.Tensor))
        base = rec.memory.start()
        fn()
        if on_card:
            torch.cuda.synchronize()
    alloc = (torch.cuda.max_memory_allocated() - base_alloc) if on_card \
        else None
    return rec.cost, rec.memory.peak - base, alloc


def _share(phase, what, c, dev_ms, dtype):
    """The bill's bound against the step's device time: at most it."""
    b_ms, by = bound(c.bytes, c.flops, dtype)
    check(b_ms <= dev_ms, f"{phase}: {what}'s bound {b_ms:.4f} ms ({by}) "
          f"exceeds its measured device time {dev_ms:.4f} ms")
    return b_ms, by


def _account_line(c):
    cats = ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in
                     sorted(c.by_op.items(), key=lambda kv: -kv[1]))
    kern = ", ".join(f"{k} x{v['launches']} {v['bytes'] / 1e6:.3f} MB "
                     f"{v['flops'] / 1e9:.3f} GFLOP"
                     for k, v in c.kernels.items())
    return (f"{c.flops / 1e9:.3f} GFLOP, {c.bytes / 1e9:.4f} GB moved "
            f"({cats}); kernels: {kern or 'none'}")


def account_decode(model, params, dev, phase="phase 22a"):
    """22a: one eager full-width decode step recorded on the card and on
    meta; equal accounts, bound within the device time, peaks."""
    from repro_torch.launch.steps import build_serve_step

    t0 = time.perf_counter()
    B = ACCT_B
    width = max(ACCT_LENS) + 1
    cache, toks, lens = _decode_setup(model, dev, B, ACCT_LENS, width, 22)
    state = dataclasses.replace(cache, seq_lens=lens)
    tok = toks[:, -1].to(torch.int32).contiguous()
    step = build_serve_step(model, device=dev)
    ops_counts = _launches()
    card, rise, alloc = _recorded(lambda: step(params, tok, state),
                                  (params, tok, state))
    launched = _launches() - ops_counts
    t_card = time.perf_counter()
    mstep = build_serve_step(model, device="meta")
    mparams, _ = model.param_specs()
    mstate = model.decode_state_specs(B, width + 64,
                                      num_blocks=cache.config.num_blocks)
    mtok = torch.empty(B, dtype=torch.int32, device="meta")
    meta, mrise, _ = _recorded(lambda: mstep(mparams, mtok, mstate),
                               (mparams, mtok, mstate))
    t_meta = time.perf_counter()
    _accounts_equal(phase, "the decode step", card, meta)
    check(card.kernels.get("paged_attention_append", {}).get("launches")
          == model.cfg.num_layers == launched,
          f"{phase}: the recorded step billed {card.kernels} and launched "
          f"{launched} kernels, want #1 once a layer")
    dev_ms, wall_ms = time_ms(lambda: step(params, tok, state),
                              iters=STEP_CALLS, warmup=2, tries=STEP_TRIES)
    b_ms, by = _share(phase, "the decode step", card, dev_ms,
                      torch.bfloat16)
    log(f"{phase}: full-width gemma-2b decode_step (B {B}, contexts "
        f"{list(ACCT_LENS)}, eager), account on the card equal to meta's: "
        f"{_account_line(card)}; bound {b_ms:.4f} ms ({by}), device "
        f"{dev_ms:.4f} ms (wall {wall_ms:.4f}), share {b_ms / dev_ms:.3f}; "
        f"peak tracker rise {rise / 1e6:.3f} MB (meta {mrise / 1e6:.3f}) "
        f"against max_memory_allocated's {alloc / 1e6:.3f} MB (not gated); "
        f"{time.perf_counter() - t0:.1f} s (card record {t_card - t0:.1f}, "
        f"meta {t_meta - t_card:.1f}) ({CARD})")
    del cache, state, toks, lens, tok, mparams, mstate
    torch.cuda.empty_cache()


def _launches() -> int:
    from repro_torch.kernels import ops
    return sum(ops.launch_counts().values())


def account_train(model, params, ost, ocfg, batch, dev, e_dev, n, tokens,
                  phase="phase 22b"):
    """22b: one eager train step (``graph=False``) of 14d's model recorded
    on the card and on meta; equal accounts, the bound within the eager
    step's device time ``e_dev`` (14d's reading of the same step), the
    tracker's rise within ACCT_PEAK_TOL of the allocator's, FLOPs over
    6 N T."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw as OPT

    t0 = time.perf_counter()
    eager = build_train_step(model, ocfg, remat=True, device=dev,
                             graph=False)
    card, rise, alloc = _recorded(lambda: eager(params, ost, batch),
                                  (params, ost))
    mparams, _ = model.param_specs()
    most = OPT.init_state(mparams)
    meager = build_train_step(model, ocfg, remat=True, device="meta",
                              graph=False)
    meta, mrise, _ = _recorded(lambda: meager(mparams, most, batch),
                               (mparams, most))
    _accounts_equal(phase, "the train step", card, meta)
    b_ms, by = _share(phase, "the train step", card, e_dev, torch.bfloat16)
    gap = abs(rise - alloc) / alloc
    check(gap <= ACCT_PEAK_TOL, f"{phase}: the peak tracker's rise "
          f"{rise} B is {gap:.3f} from max_memory_allocated's {alloc} B "
          f"(limit {ACCT_PEAK_TOL})")
    six = 6 * n * tokens
    log(f"{phase}: full-width gemma-2b eager train step (bf16, remat, "
        f"{tokens} tokens), account on the card equal to meta's: "
        f"{_account_line(card)}; FLOPs / 6 N T = {card.flops / six:.4f} "
        f"(6 N T {six / 1e12:.3f} TFLOP); bound {b_ms:.2f} ms ({by}), "
        f"device {e_dev:.2f} ms (14d), share {b_ms / e_dev:.3f}; peak "
        f"tracker rise {rise / 2**30:.4f} GiB (meta {mrise / 2**30:.4f}) "
        f"against max_memory_allocated's {alloc / 2**30:.4f} GiB, "
        f"{gap:.4f} apart (limit {ACCT_PEAK_TOL}); "
        f"{time.perf_counter() - t0:.1f} s ({CARD})")
    del mparams, most


def account_dryrun_bench(dev, phase="phase 22"):
    """22c: the dry run of gemma_2b x decode_32k on the 16 x 16
    placeholder mesh, in process; 22d: the cost-model bench's cases on
    the card."""
    from repro_torch.bench import cost_model
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    row = dryrun.run_cell("gemma_2b", "decode_32k", verbose=False)
    check(row["status"] == "ok", f"{phase}c: the dry run's row {row}")
    log(f"{phase}c: dry run gemma_2b x decode_32k, rank 0 of the 16 x 16 "
        f"placeholder mesh on meta (an account at datasheet rates, not a "
        f"measurement): {json.dumps(row)}; {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    for r in cost_model.run(dev, iters=20):
        log(f"{phase}d: cost-model case {r['name']}: predicted "
            f"{r['predicted_bytes']:.0f} B, analytic {r['analytic_bytes']:.0f}"
            f" B, ratio {r['ratio_predicted_to_analytic']:.4f} (range "
            f"[{cost_model.RATIO_LO}, {cost_model.RATIO_HI}]); raw "
            f"FlopCounterMode {r['raw']['flops']:.0f} FLOP; device "
            f"{r['ms']:.4f} ms (torch.profiler, 20 calls), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), share "
            f"{r['bound_ms'] / r['ms']:.3f} ({CARD})")
    log(f"{phase}d: {time.perf_counter() - t1:.1f} s")


def main() -> int:
    global T_START
    t_start = T_START = time.perf_counter()
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
    prefill_replay_check(model, params, dev, "phase 5", "prefill", 4, 192,
                         fault=True, profile=True)
    prefill_replay_check(model, params, dev, "phase 5", "suffix", 1, 64,
                         fault=True, profile=True)
    reduced_checks(dev, "gemma_2b", "phase 5")
    mark("phases 3-5", t_start)
    account_decode(model, params, dev)
    account_dryrun_bench(dev)
    mark("phase 22a, 22c, 22d", t_start)
    # the serving benchmarks run on phase 3's weights, which leave after
    bench_path(ops, dev, model, params)
    mark("phase 16", t_start)
    mesh_path(ops, dev, model, params)
    mark("phase 17", t_start)
    model_axis_path(ops, ref, dev, model, params)
    mark("phase 18a", t_start)
    del params
    torch.cuda.empty_cache()
    mla_model, mla_params, mla_counts, mla_last = serve_paged(
        dev, ops, mla_config(), "phase 6", MLA_PATH, MLA_TRACE_SEED)
    rows += measure_mla(ops, ref, mla_last, mla_counts)
    logits_check(mla_model, mla_params, dev, "paged_attention", "phase 6",
                 seeds=F32_SEEDS)
    prefill_replay_check(mla_model, mla_params, dev, "phase 6", "prefill", 1,
                         192)
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
    rows.append(train_path(ops, ref, dev))
    mark("phase 14", t_start)
    tp_train_path(dev)
    mark("phase 19", t_start)
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
