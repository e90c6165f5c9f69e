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
   rows);
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
   the bf16 tensor-core peak, whichever is larger);
5. compare one full-width decode step's logits between the kernel path
   and the plain path, and serve a ``reduced()`` float32 engine on both
   paths, which must decode identical tokens.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12                  # H100 SXM float32, CUDA cores
BF16_TOL = 2e-2                    # |k - p| <= tol + tol * |p|, one bf16
F32_TOL = 1e-4                     # rounding apart; float32: reordering
LOGIT_TOL = 0.1                    # full-width logits, |diff| / max|ref|
SERVE_RUNS = 5                     # timed full-width serve runs

REPLACES = {
    "paged_attention_append": "src/repro/kernels/paged_attention.py:161",
    "paged_prefill_attention": "src/repro/kernels/paged_prefill.py:99",
    "copy_pool_blocks": "src/repro/kernels/block_copy.py:128",
    "gather_blocks": "src/repro/kernels/block_copy.py:67",
    "scatter_blocks": "src/repro/kernels/block_copy.py:96",
    "block_copy": "src/repro/kernels/block_copy.py:38",
}
SOURCES = {
    "paged_attention_append": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill_attention": "src/repro_torch/kernels/csrc/paged_prefill.cu",
    "copy_pool_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "gather_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "scatter_blocks": "src/repro_torch/kernels/csrc/block_copy.cu",
    "block_copy": "src/repro_torch/kernels/csrc/block_copy.cu",
}
MAIN_PATH = ("paged_attention_append", "paged_prefill_attention",
             "copy_pool_blocks", "gather_blocks", "scatter_blocks")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


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


def time_ms(fn, iters=30, warmup=3):
    """(device ms, wall ms) per call.  Device time sums every GPU
    activity the calls launch (kernels and copies), read from a
    torch.profiler trace; wall time lies between CUDA events around the
    loop and includes the host's launch overhead when the host cannot
    keep the card busy.  A trace without device events is a failure."""
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
    prof_kw = dict(activities=[torch.profiler.ProfilerActivity.CUDA])
    with torch.profiler.profile(**prof_kw) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages())
    check(dev_us > 0, "torch.profiler recorded no device time")
    return dev_us / 1e3 / iters, wall


def bound(nbytes, flops, dtype):
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        "versions (append, prefill, copy, gather, scatter, block_copy)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
#: work of one recorded call; phase 4 replays each kernel's heaviest
#: call (decode: most live rows, then most cached keys)
WORK = {
    "paged_attention_append": lambda a: (int((a[6] > 0).sum()),
                                         int(a[6].sum())),
    "paged_prefill_attention": lambda a: (a[0].shape[0] * a[0].shape[1],
                                          int(a[4].sum())),
    "copy_pool_blocks": lambda a: len(a[1]),
    "gather_blocks": lambda a: len(a[1]),
    "scatter_blocks": lambda a: len(a[1]),
}


class Recorder:
    """Keeps the arguments of each wrapper's heaviest call during a
    serve run (small inputs cloned, pools by reference) so phase 4 can
    replay the kernels at exactly the shapes the main path gave them.
    Its clones and host syncs slow the run, so no timed run uses it."""

    def __init__(self, ops):
        self.ops = ops
        self.last = {}
        self.work = {}
        self.orig = {n: getattr(ops, n) for n in MAIN_PATH}

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

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"phase 3: {cfg.name}, {nparams / 1e9:.3f} B parameters "
        f"({nparams * 2 / 2**30:.2f} GiB bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s")

    def engine():
        return Engine(model, params, slots=4, max_seq=384, num_blocks=12,
                      eos_id=-1, watermark=0, prefill_budget=None,
                      device=dev)

    def trace():
        return make_trace("prefixheavy", 12, cfg.vocab_size, seed=0,
                          mean_gap=2.0, tenants=2, max_new=32,
                          prompt_cap=192)

    def run(rec=None):
        eng, source = engine(), trace()
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
        return eng, toks, dt, counts, st, forced

    # untimed first run: records the kernels' arguments and warms every
    # shape (cuBLAS choices, allocator) that the timed runs meet
    rec = Recorder(ops)
    rec_eng = run(rec)[0]
    log(f"phase 3: recorded run: heaviest call per kernel "
        f"{json.dumps(rec.work)}")
    rates = []
    for i in range(SERVE_RUNS):
        eng, toks, dt, counts, st, forced = run()
        rates.append(toks / dt)
        log(f"phase 3: run {i}: served 12 requests, {toks} tokens in "
            f"{dt:.4f} s = {toks / dt:.2f} tok/s over {eng.steps} steps "
            f"(slots 4, 12 blocks of 64 tokens, prefixheavy trace); "
            f"phase split (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["phase_time_s"].items()))
        if i == 0:
            first = (counts, st, forced)
        del eng
    counts, st, forced = first
    log(f"phase 3: {SERVE_RUNS} runs, tok/s median "
        f"{float(np.median(rates)):.2f}, min {min(rates):.2f}, max "
        f"{max(rates):.2f}")
    log(f"phase 3: prefix hits {st['prefix_hits']}, prefill tokens saved "
        f"{st['prefill_tokens_saved']}, COW copies {st['cow_copies']}, "
        f"preemptions {st['preemptions']}, swap-outs {st['swap_outs']} "
        f"({st['swap_out_bytes']} B), swap-ins {st['swap_ins']} "
        f"({st['swap_in_bytes']} B), compactions {st['compactions']}, "
        f"forced {forced or 'nothing'}")
    log(f"phase 3: kernel launches on the main path (run 0) "
        f"{json.dumps(counts)}; arena quiescent after every run")
    return model, params, rec_eng, counts, rec.last


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 4: main-path shapes, compare and time
# ---------------------------------------------------------------------------
def measure(ops, ref, last, counts):
    F = torch.nn.functional
    rows = []

    def row(name, err, k, p, nbytes, flops, dtype, lib):
        b_ms, by = bound(nbytes, flops, dtype)
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name],
                     "launches": int(counts[name]), "max_abs_err": err,
                     "ms": k[0], "plain_ms": p[0], "bound_ms": b_ms,
                     "bound_by": by,
                     "library_ms": None if lib is None else lib[0]})
        lib_s = ("n/a" if lib is None
                 else f"{lib[0]:.4f} ms ({lib[1]:.4f} ms per call)")
        log(f"phase 4: {name}: max_abs_err {err:.3e}; device time kernel "
            f"{k[0]:.4f} ms ({k[1]:.4f} ms per call), plain {p[0]:.4f} ms "
            f"({p[1]:.4f} ms per call), library {lib_s}; bound "
            f"{b_ms:.5f} ms ({by}; {nbytes} B, {flops} flop)")

    # -- decode append ------------------------------------------------------
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
    err = assert_close("append (main path)", o[own], ro[own], BF16_TOL)
    keep = torch.ones(NB, dtype=torch.bool, device=q.device)
    keep[tail[shared]] = False
    check(torch.equal(k[keep], rk[keep]) and torch.equal(v[keep], rv[keep]),
          "append pools differ")
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
    row("paged_attention_append", err, ms, pms, nbytes, flops, kp.dtype, lib)

    # -- suffix prefill -----------------------------------------------------
    (q, kp, vp, tables, kl, st), kw = last["paged_prefill_attention"]
    B, SQ, KVH, G, HD = q.shape
    BT, VD, MB = kp.shape[1], vp.shape[-1], tables.shape[1]
    ro = ref.paged_prefill_attention_ref(q, kp, vp, tables, kl, st, **kw)
    o = ops.paged_prefill_attention(q, kp, vp, tables, kl, st, **kw)
    torch.cuda.synchronize()
    err = assert_close("prefill (main path)", o, ro, BF16_TOL)
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
    row("paged_prefill_attention", err, ms, pms, nbytes, flops, kp.dtype,
        lib)

    # -- block movement -----------------------------------------------------
    (pool, src, dst), _ = last["copy_pool_blocks"]
    src, dst = np.asarray(src), np.asarray(dst)
    a, b = pool.clone(), pool.clone()
    ops.copy_pool_blocks(a, src, dst)
    ref.copy_pool_blocks_ref(b, torch.from_numpy(src), torch.from_numpy(dst))
    check(torch.equal(a, b), "copy_pool_blocks (main path) differs")
    blk = pool[0, 0].numel() * pool.element_size()
    mv = 2 * len(src) * pool.shape[0] * blk
    ms = time_ms(lambda: ops.copy_pool_blocks(a, src, dst))
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    pms = time_ms(lambda: ref.copy_pool_blocks_ref(b, s_t, d_t))
    row("copy_pool_blocks", 0.0, ms, pms, mv, 0, pool.dtype, None)

    (pool, idx), _ = last["gather_blocks"]
    idx = np.asarray(idx)
    got = ops.gather_blocks(pool, idx)
    check(torch.equal(got, ref.gather_blocks_ref(pool, torch.from_numpy(idx))),
          "gather_blocks (main path) differs")
    mv = 2 * got.numel() * got.element_size()
    ms = time_ms(lambda: ops.gather_blocks(pool, idx))
    i_t = torch.from_numpy(idx)
    pms = time_ms(lambda: ref.gather_blocks_ref(pool, i_t))
    i_d = i_t.to(pool.device).long()
    lib = time_ms(lambda: torch.index_select(pool, 1, i_d))
    row("gather_blocks", 0.0, ms, pms, mv, 0, pool.dtype, lib)

    (pool, idx, payload), _ = last["scatter_blocks"]
    idx = np.asarray(idx)
    payload = payload.to(pool.device)
    a, b = pool.clone(), pool.clone()
    ops.scatter_blocks(a, idx, payload)
    ref.scatter_blocks_ref(b, torch.from_numpy(idx), payload)
    check(torch.equal(a, b), "scatter_blocks (main path) differs")
    mv = 2 * payload.numel() * payload.element_size()
    ms = time_ms(lambda: ops.scatter_blocks(a, idx, payload))
    i_t = torch.from_numpy(idx)
    pms = time_ms(lambda: ref.scatter_blocks_ref(b, i_t, payload))
    i_d = i_t.to(pool.device).long()
    lib = time_ms(lambda: b.index_copy_(1, i_d, payload))
    row("scatter_blocks", 0.0, ms, pms, mv, 0, pool.dtype, lib)
    return rows


# ---------------------------------------------------------------------------
# phase 5: kernel path vs plain path, end to end
# ---------------------------------------------------------------------------
def logits_check(model, params, dev):
    from repro_torch.core.paged_kv import PagedKVCache, PagedKVManager
    from repro_torch.models.api import build_model

    plain = build_model(model.cfg, plain=True)
    B, S0 = 3, 150
    kv = model.kv_config(max_seq=256, batch=B)
    mgr = PagedKVManager(kv)
    tables = np.stack([(mgr.admit(i, 256), mgr.device_table(i))[1]
                       for i in range(B)])
    cache = PagedKVCache.create(kv, B, device=dev)
    cache.block_tables.copy_(torch.as_tensor(tables))
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    toks = torch.randint(2, model.cfg.vocab_size, (B, 192), generator=g)
    toks = toks.to(dev)
    lens = torch.tensor([S0, 100, 191], dtype=torch.int32, device=dev)
    _, cache = model.prefill(params, toks, cache, lens)
    nxt = toks[torch.arange(B), lens.long() % 192]
    c2 = dataclasses.replace(cache, k_pool=cache.k_pool.clone(),
                             v_pool=cache.v_pool.clone())
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    lk, _ = model.decode_step(params, nxt, cache)
    n_kernel = ops.launch_counts()["paged_attention_append"]
    lp, _ = plain.decode_step(params, nxt, c2)
    torch.cuda.synchronize()
    check(n_kernel == model.cfg.num_layers
          and ops.launch_counts()["paged_attention_append"] == n_kernel,
          "the kernel path did not launch one append per layer, or the "
          "plain path launched one")
    check(torch.isfinite(lk).all().item(), "non-finite kernel-path logits")
    err = max_err(lk, lp)
    rel = err / float(lp.abs().max())
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    log(f"phase 5: full-width decode step, kernel vs plain path: max |diff| "
        f"{err:.4e} = {rel:.4e} of max |logit| (tol {LOGIT_TOL}), argmax "
        f"agrees on {agree}/{B} rows")
    check(rel <= LOGIT_TOL, "kernel-path logits differ from the plain path")
    dev_ms, wall_ms = time_ms(lambda: model.decode_step(params, nxt, cache),
                              iters=10, warmup=2)
    log(f"phase 5: one full-width decode step ({B} rows, "
        f"{model.cfg.num_layers} layers): "
        f"{wall_ms:.3f} ms wall, {dev_ms:.3f} ms of device activity, "
        f"device idle share {1 - dev_ms / wall_ms:.3f}")
    return err, rel


def reduced_token_identity(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.traffic import make_trace

    cfg = get_config("gemma_2b").reduced()
    check(cfg.dtype == "float32", "reduced config is not float32")
    out = {}
    for plain in (False, True):
        model = build_model(cfg, plain=plain)
        params = model.init(seed=3, device=dev)
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
    log(f"phase 5: reduced float32 engine on the card, kernel vs plain path: "
        f"{'identical' if same else 'DIFFERENT'} tokens over "
        f"{len(out[False][0])} requests (prefix hits {st['prefix_hits']}, "
        f"preemptions {st['preemptions']})")
    check(len(out[False][0]) == 10, "reduced engine did not finish")
    check(same, "reduced float32 tokens differ between kernel and plain path")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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

    small_checks(ops, ref, dev)
    model, params, eng, counts, last = serve_full_width(
        dev, ops, full_width_config())
    rows = measure(ops, ref, last, counts)
    del eng
    logits_check(model, params, dev)
    del params
    torch.cuda.empty_cache()
    reduced_token_identity(dev)
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
