"""Render the dry run's rows (``repro_torch.launch.dryrun``) as the
roofline tables, and BENCH_serve.json snapshots
(``repro_torch.bench.serve``) as the serving tables: the unified
address space (``ArenaStats``), the transfer plane, per-tenant latency,
per-family serving, the resident decode path and migration.

    python -m repro_torch.report dryrun_report.jsonl
    python -m repro_torch.report BENCH_serve.json
    python -m repro_torch.report BENCH_migrate.json   # migration only

The reference's ``report.py``, table for table, so the same rows and
snapshots render to the same text in both packages.  A dry-run row's
terms here are the port's account at the H100's datasheet rates
(``roofline.py``), not a measurement.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def load(path: str) -> List[Dict]:
    rows = []
    for line in open(path):
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return rows


def fmt_table(rows: List[Dict], mesh: str) -> str:
    out = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | dominant mem op | useful/HLO | roofline frac | "
           "peak GB/chip |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"N/A-by-spec | — | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | | | "
                       f"{r.get('error','')[:60]} | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f} | "
            f"{r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} | "
            f"{r['bottleneck']} | {r.get('dominant_mem_op', '-')} | "
            f"{r['useful_flops_ratio']:.3f} | "
            f"**{r['roofline_fraction']:.3f}** | "
            f"{r['peak_mem_gb_per_chip']:.1f} |")
    return "\n".join(out)


def fmt_dryrun_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | mesh | status | HLO GFLOP/chip | HBM GB/chip | "
           "coll GB/chip | compile (s) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
                f"{r['hlo_gflops_per_chip']:.0f} | "
                f"{r['hbm_gb_per_chip']:.1f} | {r['coll_gb_per_chip']:.2f} | "
                f"{r.get('t_compile_s','')} |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']} | — | — | — | — |")
    return "\n".join(out)


def fmt_arena_table(arena: Dict) -> str:
    """Render an ``ArenaStats.to_dict()`` snapshot (the ``arena`` key of
    BENCH_serve.json) as the unified-address-space table: one row per
    pool class with placement split, sharing, locality metrics, and
    blocks used/free per dp pool group when the class is partitioned."""
    out = ["| pool class | blocks | used | free | pinned | host tier | "
           "COW-shared | frag | table locality | owners | dp groups | "
           "tenant used/quota |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(arena.get("classes", {})):
        c = arena["classes"][name]
        hist = c.get("refcount_histogram", [])
        shared = sum(hist[2:]) if len(hist) > 2 else 0
        groups = " ".join(f"g{g['group']} {g['used']}/{g['free']}"
                          for g in c.get("groups", [])) or "—"
        # pre-quota snapshots lack both tenant dicts: render "n/a",
        # never KeyError (same degradation contract as the tenant
        # latency table)
        quotas = c.get("quota_by_tenant")
        if quotas is None:
            quota_cell = "n/a"
        elif not quotas:
            quota_cell = "—"
        else:
            used = c.get("blocks_by_tenant", {})
            quota_cell = " ".join(f"{t}:{used.get(t, 0)}/{q}"
                                  for t, q in sorted(quotas.items()))
        out.append(
            f"| {name} | {c['num_blocks']} | {c['num_used']} | "
            f"{c['num_free']} | {c['pinned']} | {c['host_blocks']} | "
            f"{shared} | {c['fragmentation']:.3f} | "
            f"{c['table_locality']:.3f} | {len(c['blocks_by_owner'])} | "
            f"{groups} | {quota_cell} |")
    out.append("")
    out.append(f"compactions: {arena.get('compactions', 0)} "
               f"(blocks moved: {arena.get('blocks_compacted', 0)})")
    return "\n".join(out)


def fmt_transfer_table(tr: Dict) -> str:
    """Render a ``TransferStats.to_dict()`` snapshot: one row per DMA
    ENGINE (plans, bytes, per-engine queue depth and overlap) plus the
    scheduling counters of the multi-queue plane."""
    out = ["| engine | enqueued | completed | bytes moved | "
           "max depth | overlapped |",
           "|---|---|---|---|---|---|"]
    names = {"d2d": "d2d (COW / compaction)",
             "d2h": "d2h (swap-out)",
             "h2d": "h2d (swap-in / prefetch)"}

    def per_engine(field, d):
        v = tr.get(field, 0)
        # pre-multi-queue snapshots carried a single global counter
        return v.get(d, 0) if isinstance(v, dict) else v

    for d in ("d2d", "d2h", "h2d"):
        out.append(f"| {names[d]} | {tr['enqueued'].get(d, 0)} | "
                   f"{tr['completed'].get(d, 0)} | "
                   f"{tr['bytes_moved'].get(d, 0)} | "
                   f"{per_engine('max_pending', d)} | "
                   f"{per_engine('overlapped', d)} |")
    out.append("")
    out.append(
        f"launches: {tr.get('launches', 0)} "
        f"(coalesced plans: {tr.get('coalesced', 0)}, "
        f"reordered past a blocked plan: {tr.get('reordered', 0)}) · "
        f"dispatches: {tr.get('dispatches', 0)} · "
        f"drains: {tr.get('drains', 0)}")
    if "python_launches" in tr or "dispatches_per_step" in tr:
        out.append(
            f"step-loop overhead: {tr.get('python_launches', 0)} "
            f"python launches · "
            f"{tr.get('dispatches_per_step', 0.0)} dispatches/step")
    if tr.get("prefetch_enqueued"):
        rate = tr.get("prefetch_hit_rate")
        rate_s = "" if rate is None else f", hit rate {rate:.2f}"
        out.append(
            f"prefetch lane: {tr['prefetch_enqueued']} speculative "
            f"swap-ins ({tr.get('prefetch_completed', 0)} completed, "
            f"{tr.get('prefetch_committed', 0)} committed, "
            f"{tr.get('prefetch_cancelled', 0)} cancelled{rate_s})")
    else:
        # zero speculative plans ever launched: a hit rate is undefined
        # (the old snapshots' vacuous 1.0 here was misleading)
        out.append("prefetch lane: idle (hit rate n/a)")
    return "\n".join(out)


def fmt_tenant_latency_table(doc: Dict) -> str:
    """Render the request plane's per-tenant latency section
    (``tenant_latency`` + ``arrival_trace`` of BENCH_serve.json).

    Degrades gracefully on pre-request-plane snapshots that lack the
    section entirely, and on tenants whose percentile values are null
    (too few tokens to measure): both render as "n/a", never KeyError.
    """
    out = ["| tenant | requests | TTFT p50 (ms) | TTFT p99 (ms) | "
           "ITL p50 (ms) | ITL p99 (ms) |",
           "|---|---|---|---|---|---|"]

    def cell(v):
        return "n/a" if v is None else f"{v:.2f}"

    tl = doc.get("tenant_latency")
    if not tl:
        out.append("| n/a | n/a | n/a | n/a | n/a | n/a |")
        out.append("")
        out.append("no per-tenant section in this snapshot "
                   "(pre-request-plane BENCH_serve.json)")
        return "\n".join(out)
    for tenant in sorted(tl):
        r = tl[tenant]
        out.append(f"| {tenant} | {r.get('requests', 'n/a')} | "
                   f"{cell(r.get('ttft_p50_ms'))} | "
                   f"{cell(r.get('ttft_p99_ms'))} | "
                   f"{cell(r.get('itl_p50_ms'))} | "
                   f"{cell(r.get('itl_p99_ms'))} |")
    tr = doc.get("arrival_trace") or {}
    out.append("")
    out.append(f"arrival trace: {tr.get('kind', 'n/a')} "
               f"(seed {tr.get('seed', 'n/a')}, "
               f"{tr.get('requests', 'n/a')} requests over "
               f"{tr.get('tenants', 'n/a')} tenants, mean gap "
               f"{tr.get('mean_gap_steps', 'n/a')} steps)")
    hist = doc.get("latency_histogram") or {}
    if hist.get("counts"):
        edges, counts = hist.get("edges_ms", []), hist["counts"]
        buckets = " ".join(
            f"[{edges[i]:.0f},{edges[i + 1]:.0f}):{c}"
            for i, c in enumerate(counts) if i + 1 < len(edges))
        out.append(f"TTFT histogram (ms): {buckets}")
    return "\n".join(out)


def fmt_family_table(doc: Dict) -> str:
    """Render the ``mixed_arch`` section of BENCH_serve.json: one row
    per model family served from the shared arena, with its registry
    strategy, pool classes and throughput.

    Degrades gracefully on pre-architecture-registry snapshots that
    lack the section entirely: renders an "n/a" row and says why,
    never KeyError (same contract as the tenant latency table).
    """
    out = ["| family | strategy | pool classes | decode tokens | "
           "tokens/s | preemptions | swap out/in | tokens match |",
           "|---|---|---|---|---|---|---|---|"]
    ma = doc.get("mixed_arch")
    if not ma or not ma.get("families"):
        out.append("| n/a | n/a | n/a | n/a | n/a | n/a | n/a | n/a |")
        out.append("")
        out.append("no mixed-architecture section in this snapshot "
                   "(pre-architecture-registry BENCH_serve.json)")
        return "\n".join(out)

    def cell(v, fmt="{}"):
        return "n/a" if v is None else fmt.format(v)

    for fam in sorted(ma["families"]):
        r = ma["families"][fam]
        tps = r.get("tokens_per_s")
        out.append(
            f"| {fam} | {r.get('strategy', 'n/a')} | "
            f"{' '.join(r.get('pool_classes', [])) or 'n/a'} | "
            f"{cell(r.get('decode_tokens'))} | "
            f"{'n/a' if tps is None else f'{tps:.1f}'} | "
            f"{cell(r.get('preemptions'))} | "
            f"{cell(r.get('swap_outs'))}/{cell(r.get('swap_ins'))} | "
            f"{r.get('tokens_match', 'n/a')} |")
    return "\n".join(out)


def fmt_decode_path_table(doc: Dict) -> str:
    """Render the resident-decode section of BENCH_serve.json: the
    ``decode_path`` probe (device-persistent tables + delta sync + the
    fused donated step tail vs the eager full-rebuild fallback) and the
    workload run's per-step phase breakdown.

    Degrades gracefully on pre-resident snapshots that lack the
    section: renders an "n/a" row and says why, never KeyError (same
    contract as the other section tables).
    """
    out = ["| mode | tokens/s | uploads/step | rows scattered | "
           "sync bytes | completed |",
           "|---|---|---|---|---|---|"]
    dp = doc.get("decode_path")
    if not dp or "resident" not in dp:
        out.append("| n/a | n/a | n/a | n/a | n/a | n/a |")
        out.append("")
        out.append("no resident-decode section in this snapshot "
                   "(pre-resident-path BENCH_serve.json)")
        return "\n".join(out)

    def cell(v):
        return "n/a" if v is None else v

    for mode in ("resident", "eager"):
        r = dp.get(mode) or {}
        tps = r.get("tokens_per_s")
        out.append(
            f"| {mode} | {'n/a' if tps is None else f'{tps:.1f}'} | "
            f"{cell(r.get('host_uploads_per_step'))} | "
            f"{cell(r.get('table_rows_updated'))} | "
            f"{cell(r.get('table_sync_bytes'))} | "
            f"{cell(r.get('completed'))} |")
    out.append("")
    out.append(f"token identical: {dp.get('token_identical', 'n/a')}")
    ph = doc.get("phase_time_s")
    if ph:
        total = sum(ph.values()) or 1.0
        shares = ", ".join(f"{k} {v / total:.0%}"
                           for k, v in sorted(ph.items(),
                                              key=lambda kv: -kv[1]))
        out.append(f"workload step-phase wall share: {shares} "
                   f"(uploads/step "
                   f"{doc.get('host_uploads_per_step', 'n/a')}, "
                   f"table sync bytes "
                   f"{doc.get('table_sync_bytes', 'n/a')})")
    return "\n".join(out)


def fmt_migrate_table(doc: Dict) -> str:
    """Render the cross-process section (``migrate`` of
    BENCH_serve.json, or a standalone BENCH_migrate.json): the live
    migration's pre-copy/stop-and-copy breakdown and the
    prefill/decode-disaggregation handoff line.

    Degrades gracefully on pre-migration snapshots that lack the
    section: renders an "n/a" row and says why, never KeyError (same
    contract as the tenant latency and family tables).
    """
    out = ["| phase | rounds | blocks | bytes | pause steps | "
           "token identical |",
           "|---|---|---|---|---|---|"]
    mg = doc.get("migrate", doc if "migration" in doc else None)
    if not mg or not mg.get("migration"):
        out.append("| n/a | n/a | n/a | n/a | n/a | n/a |")
        out.append("")
        out.append("no cross-process section in this snapshot "
                   "(pre-migration BENCH_serve.json)")
        return "\n".join(out)
    m = mg["migration"]

    def cell(v):
        return "n/a" if v is None else v

    out.append(
        f"| pre-copy | {cell(m.get('rounds'))} | "
        f"{cell(m.get('precopy_blocks'))} | "
        f"{cell(m.get('precopy_bytes'))} | — | — |")
    out.append(
        f"| stop-and-copy | — | {cell(m.get('stop_copy_blocks'))} | "
        f"{cell(m.get('stop_copy_bytes'))} | "
        f"{cell(m.get('pause_steps'))} | "
        f"{m.get('token_identical', 'n/a')} |")
    per_round = m.get("blocks_per_round")
    if per_round:
        out.append("")
        out.append("blocks per pre-copy round: "
                   + " -> ".join(str(b) for b in per_round)
                   + f" (stop-copy tail {m.get('stop_copy_blocks', 'n/a')})")
    d = mg.get("disagg")
    if d:
        out.append(
            f"prefill/decode handoff: {d.get('handoffs', 'n/a')} bundles, "
            f"{d.get('handoff_bytes', 'n/a')} bytes, token identical: "
            f"{d.get('token_identical', 'n/a')}")
    return "\n".join(out)


def main(path: str) -> None:
    if not path.endswith(".json"):
        rows = load(path)
        print("### Single-pod (16x16 = 256 chips)\n")
        print(fmt_table(rows, "16x16"))
        print("\n### Multi-pod (2x16x16 = 512 chips)\n")
        print(fmt_table(rows, "pod2x16x16"))
        return
    with open(path) as f:
        doc = json.load(f)
    if "migration" in doc:        # standalone BENCH_migrate.json
        print("### Cross-process: live migration + disaggregation\n")
        print(fmt_migrate_table(doc))
        return
    arena = doc.get("arena", doc if "classes" in doc else None)
    if arena is None:
        raise SystemExit(f"{path}: no ArenaStats ('arena' key) found")
    print("### Unified address space (ArenaStats)\n")
    print(fmt_arena_table(arena))
    transfers = doc.get("transfers") or arena.get("transfers")
    if transfers:
        print("\n### Transfer plane (TransferStats)\n")
        print(fmt_transfer_table(transfers))
    print("\n### Request plane: per-tenant latency\n")
    print(fmt_tenant_latency_table(doc))
    print("\n### Architecture registry: per-family serving\n")
    print(fmt_family_table(doc))
    print("\n### Resident decode path: delta sync + fused tail\n")
    print(fmt_decode_path_table(doc))
    print("\n### Cross-process: live migration + disaggregation\n")
    print(fmt_migrate_table(doc))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "BENCH_serve.json")
