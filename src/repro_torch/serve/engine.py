"""Serving mechanism layer: executes scheduler decisions on the device.

Counterpart of ``repro.serve.engine``: the same step loop, scheduler
negotiation, COW prefix sharing, transfer schedule and resident decode
tail, on PyTorch tensors (pools on ``device``, CUDA by default).  Where
the reference jits the decode tail once per update width, the tail here
is captured as one CUDA graph per width and replayed
(``serve/decode_graph.py``).  Where it jits the paged prefill and
suffix prefill once per ``(B, S)`` bucket, each bucket here is captured
at its second sighting and replayed from then on
(``serve/prefill_graph.py``).  ``graphs=False`` runs both eagerly.

The serving stack is four layers over one address space
(the reference package's ``serve/README.md`` and ``mem/README.md``
describe them):

  * ``scheduler.py`` -- POLICY: pluggable admission order (FCFS with
    priority classes and earliest-deadline-first within a class pinned
    default; per-tenant deficit round-robin fairness) negotiated
    against the strategy's per-pool-class grantable leases, per-tenant
    block quotas, deadline-cost victim choice falling back to LIFO,
    per-step prefill budgeting, an adaptive free-block watermark fed by
    observed growth (growing classes only).  No tensors.
  * ``arch.py`` -- DISCIPLINE: the architecture registry.  What a
    model family's decode-time state IS (growing paged KV, a
    fixed-size recurrent state, or both) and which Arena pool classes
    back it.  The engine holds exactly ONE ``CacheStrategy`` and never
    inspects the model; ``resolve(model)`` is the only dispatch point.
  * ``swap.py`` -- LEDGER: the byte ledger and residency views over the
    transfer plane; swap cost scales with blocks held, never pool size.
  * ``repro_torch.mem`` -- ADDRESS SPACE + TRANSFER PLANE: allocation,
    refcounts, the COW write barrier, pressure-time reclaim (this
    engine registers its LIFO preemption as the reclaimer for each of
    its strategy's pool classes), ``compact()``, and the
    ``TransferQueue`` every payload move rides (``mem/transfer.py`` is
    the only module that touches the block-copy kernels).
  * this module -- MECHANISM: one decode step for a fixed slot count B
    (padding empty slots, so every step launches the same shapes), ONE
    padded batched prefill for all of a step's admissions,
    COW prefix sharing (when the strategy supports it), and the
    SCHEDULE of the per-engine transfer queues: the step loop fences
    step N-1's d2h host copies, produces this step's plans (compaction,
    swap-in, growth preemptions, COW), dispatches every engine's URGENT
    lane, then speculatively prefetches the scheduler's LIFO resume
    candidate on the BACKGROUND h2d lane, then decodes -- so swap-out
    host copies AND the prefetch scatter overlap the decode (dispatch
    at N, fence at N+1).  A prefetched resume commits bookkeeping
    instead of swapping in synchronously; pressure cancels speculation
    before preempting anyone, which keeps every scheduling decision
    identical to the non-speculative schedule.
    ``overlap_transfers=False`` selects the synchronous ``drain()``
    fallback (prefetch off), which is token-identical and
    byte-identical by construction (pinned in tests).

Compaction runs when the Arena reports plentiful free blocks and poor
table locality (``COMPACT_FREE_FRAC``/``COMPACT_FRAG_THRESHOLD``);
prefix sharing is on where the strategy supports it (the paged
discipline; a recurrent state depends on the whole prefix, so the
constant and composite disciplines refuse it) and speculative prefetch
where the strategy allows it (only on the overlapped schedule).

COW prefix sharing end-to-end: every admitted prompt
registers its block-aligned prefixes in a hash map; a later prompt that
matches forks instead of re-allocating, aliasing whole blocks --
including a partially-filled tail block when the new prompt is an exact
prefix of (or equal to) the parent's.  The first divergent write into a
shared block hits the ``ensure_writable`` barrier, which fulfils the
copy (``fork_for_write`` + one device block copy).  Relocation,
swapping and COW are exactly the paper's Table 1 rows, re-created in
software over a paged pool.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.mem import BACKGROUND, URGENT, Arena, LeaseRevokedError
from repro_torch.serve.arch import build_strategy
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "Request"]

#: compaction policy: defrag when at least this share of the pool is
#: free AND table locality has fallen below the threshold
COMPACT_FREE_FRAC = 0.5
COMPACT_FRAG_THRESHOLD = 0.5


class Engine:
    """Slot-based continuous batching over one cache strategy.

    The model's family selects the discipline through the architecture
    registry (``serve/arch.py``): decoder LMs expose prefill/decode_step
    over a ``PagedKVCache``, SSMs over a constant state pool, the
    hybrid over both.  Greedy sampling.  ``device`` (default
    ``"cuda"``) places the pools; the params must live there too.

    ``arena`` lets engines of different families share one Arena;
    ``pool_prefix`` namespaces this engine's pool classes in it.
    ``state_blocks`` sizes a composite strategy's state pool.
    ``share_prefixes`` and ``prefetch`` (default on, where the strategy
    and the overlapped schedule allow them) turn COW prefix sharing and
    speculative swap-in off, as a prefill worker does.
    ``graphs`` (default on) replays, on a CUDA device, the resident
    decode tail from one captured CUDA graph per update width, and a
    paged strategy's prefill and suffix prefill from one captured CUDA
    graph per ``(B, S)`` bucket from the bucket's second sighting on;
    False runs both eagerly on the same static buffers, as the CPU
    always does.  A replayed prefill takes other seconds than an eager
    one, and ``prefill_budget="auto"`` feeds those seconds into
    admission, so runs that must match token for token (replayed against
    eager) take ``prefill_budget=None``.

    All block bookkeeping lives in the engine's own
    ``repro_torch.mem.Arena``.  The engine registers itself as the
    reclaimer for its strategy's pool classes: when any allocation
    (table growth, COW copy target) exhausts a pool,
    the Arena calls back into LIFO preemption instead of failing --
    ``LeaseRevokedError`` surfaces only when the requester itself was
    the victim.
    """

    def __init__(self, model, params, *, slots: int, max_seq: int,
                 num_blocks: int, eos_id: int = 1,
                 watermark: Optional[int] = None,
                 prefill_budget="auto",
                 admission_policy=None,
                 share_prefixes: bool = True,
                 overlap_transfers: bool = True,
                 prefetch: bool = True,
                 suffix_prefill: bool = True,
                 resident_tables: bool = True,
                 graphs: bool = True,
                 arena: Optional[Arena] = None,
                 dp_groups: int = 1,
                 pool_prefix: str = "",
                 state_blocks: Optional[int] = None,
                 device="cuda"):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_id
        self.dp_groups = dp_groups
        if dp_groups > 1:
            # group-batched caches read table entries as group-LOCAL ids
            # but the Arena hands out GLOBAL ids -- running would
            # silently corrupt the pool, as in the reference, which
            # refuses the same way; the mesh serve step
            # (launch/steps.build_serve_step) is where dp groups run
            raise NotImplementedError(
                "dp_groups > 1 serving needs group-partitioned block "
                "allocation; refusing to run with group-oblivious ids")
        self.arena = arena if arena is not None else Arena()
        # the registry hands back the model family's cache discipline;
        # the strategy owns pool classes, device streams, managers and
        # transfer-plane executors.  pool_prefix namespaces the classes
        # so engines of different families can share one arena.
        self.strategy = build_strategy(
            model, arena=self.arena, slots=slots, max_seq=max_seq,
            num_blocks=num_blocks, pool_prefix=pool_prefix,
            state_blocks=state_blocks, device=device)
        self.device = self.strategy.device
        self.sched = Scheduler(watermark=watermark,
                               prefill_budget=prefill_budget,
                               policy=admission_policy,
                               arena=self.arena)
        # admission/chunking bills suffix tokens only for forked children
        self.sched.prefill_cost_fn = self._prefill_cost
        # pressure ownership is per pool class: on a shared arena each
        # engine reclaims only for the classes it serves
        for cls in self.strategy.pool_classes:
            self.arena.set_reclaimer(self._reclaim_for_pressure,
                                     pool_class=cls)
        self.transfers = self.arena.transfers
        self.transfers.eager = not overlap_transfers
        # speculative swap-in of the scheduler's LIFO resume candidate:
        # enqueued on the background h2d lane while decode runs, so the
        # real resume skips the synchronous swap-in.  Only meaningful
        # on the overlapped schedule -- the eager fallback would
        # serialize the speculation anyway.
        self.prefetch_enabled = prefetch and overlap_transfers
        # prefix sharing and suffix-only prefill require the strategy's
        # consent: a recurrent state depends on the ENTIRE prefix, so
        # constant/composite disciplines refuse both
        self.share_prefixes = (share_prefixes
                               and self.strategy.supports_prefix_sharing)
        self.suffix_prefill = (suffix_prefill
                               and self.strategy.supports_suffix_prefill)
        # resident decode path: device tables/rows are incrementally
        # maintained (delta scatter of dirty slots only) and the step
        # tail -- splice, decode, argmax -- is ONE replay of the CUDA
        # graph captured for its update width, with the next-token
        # vector latched on device (``graphs=False``: the same
        # tail, eager).  ``resident_tables=False`` is the pinned
        # full-rebuild fallback, mirroring the
        # ``overlap_transfers``/``drain()`` pattern.
        self.resident_tables = resident_tables
        self.strategy.resident = resident_tables
        self.strategy.graphs = graphs
        self._tok_dev = None           # device-latched next-token vector
        self._tok_dirty = True         # host wrote _next_tok -> re-upload
        self.host_uploads = 0          # step tails with any h2d upload
        self.table_sync_bytes = 0
        self.table_rows_updated = 0
        # "prefill": the admissions' prefill calls, host copy of the
        # argmax included; "dispatch" is the rest of a step's first part
        self.phase_time = {"dispatch": 0.0, "prefill": 0.0, "sync": 0.0,
                           "decode": 0.0, "retire": 0.0}
        self.running: Dict[int, Request] = {}   # slot -> req
        self.done: List[Request] = []
        self._prefix_map: Dict[Tuple[int, bytes], List[int]] = {}
        self._live_prompts: Dict[int, np.ndarray] = {}
        self._next_tok = np.zeros(slots, np.int64)
        self.steps = 0
        self.prefix_hits = 0
        self.cow_copies = 0
        self.preemptions = 0
        self.rejections = 0        # over-quota admissions refused
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0  # prefix tokens NOT recomputed
        self.decode_tokens = 0
        self.prefetches = 0        # speculative swap-ins launched
        self.prefetch_hits = 0     # resumes served from a COMPLETED prefetch
        self.prefetch_cancels = 0  # speculations withdrawn (pressure/free)

    # ---------------- strategy views (compat surface) ----------------
    @property
    def mgr(self):
        """The strategy's primary block manager (paged KV for
        transformers and hybrids, the constant-state manager for SSMs).
        """
        return self.strategy.mgr

    @property
    def cache(self):
        """The paged KV device cache, when the discipline has one."""
        return getattr(self.strategy, "cache", None)

    @cache.setter
    def cache(self, value) -> None:
        self.strategy.cache = value

    @property
    def store(self):
        """Primary pool class's host-tier swap ledger."""
        return self.strategy.store

    @property
    def sink(self) -> int:
        """Current physical id of the pinned write-sink block."""
        return self.strategy.sink

    def sync_transfers(self) -> None:
        """Fence everything: drain the transfer plane to completion
        (the synchronous fallback, also used by tests that inspect the
        byte ledger right after a forced preemption)."""
        self.transfers.drain()

    def release_arena(self) -> None:
        """Detach this engine from its arena so the arena stops retaining
        it (executor and observer closures hold the engine, and with it
        params and the device pools; the captured decode graphs hold
        their addresses).  Drains outstanding plans, then unbinds
        reclaimers, executors, swap ledgers and the decode graphs; the
        arena can be handed to a new engine afterwards."""
        self.transfers.drain()
        for cls in self.strategy.pool_classes:
            if self.arena._reclaimers.get(cls) == self._reclaim_for_pressure:
                self.arena.set_reclaimer(None, pool_class=cls)
        self.strategy.release_arena()

    # ---------------- intake / compat views ----------------
    def submit(self, req: Request) -> None:
        if req.t_submit < 0:
            req.t_submit = time.perf_counter()
        self.sched.submit(req)

    @property
    def queue(self) -> List[Request]:
        return self.sched.queue

    @property
    def preempted(self):
        return self.sched.preempted

    # ---------------- prefix sharing (COW) ----------------
    def _register_prefix(self, req: Request) -> None:
        if not self.share_prefixes:
            return
        pr = np.ascontiguousarray(np.asarray(req.prompt, np.int64))
        bt = self.strategy.block_tokens
        for k in range(1, len(pr) // bt + 1):
            rids = self._prefix_map.setdefault((k, pr[: k * bt].tobytes()),
                                               [])
            if req.rid not in rids:
                rids.append(req.rid)
        self._live_prompts[req.rid] = pr

    def _deregister_prefix(self, req: Request) -> None:
        pr = self._live_prompts.pop(req.rid, None)
        if pr is None:
            return
        bt = self.strategy.block_tokens
        for k in range(1, len(pr) // bt + 1):      # only this rid's keys
            key = (k, pr[: k * bt].tobytes())
            rids = self._prefix_map.get(key)
            if rids is None:
                continue
            if req.rid in rids:
                rids.remove(req.rid)
            if not rids:
                del self._prefix_map[key]

    def _find_parent(self, req: Request) -> Tuple[Optional[int], int]:
        """Longest live shared prefix: (parent rid, shareable tokens).

        Shares whole blocks of the common prefix; additionally shares
        the parent's partially-filled tail block when the new prompt is
        entirely contained in the parent's (divergent writes into it are
        COW-resolved later).
        """
        if not self.share_prefixes:
            return None, 0
        pr = np.ascontiguousarray(np.asarray(req.prompt, np.int64))
        bt = self.strategy.block_tokens
        for k in range(len(pr) // bt, 0, -1):
            for rid in self._prefix_map.get((k, pr[: k * bt].tobytes()), []):
                if rid == req.rid or not self.strategy.has_seq(rid) \
                        or rid not in self._live_prompts:
                    continue
                parent = self._live_prompts[rid]
                n = min(len(pr), len(parent))
                neq = np.nonzero(pr[:n] != parent[:n])[0]
                common = int(neq[0]) if len(neq) else n
                shared = (common if common == len(pr)
                          else (common // bt) * bt)
                if shared > 0:
                    return rid, shared
        return None, 0

    def _prefill_cost(self, req: Request) -> int:
        """Prefill tokens this request will actually compute: the whole
        prompt, or only the un-cached suffix when a live parent shares
        its prefix (suffix-only prefill).  Used by the scheduler's
        admission budget; the plan-time parent lookup predates the same
        step's other placements, so it can only overestimate."""
        if not self.suffix_prefill:
            return req.tokens_held
        parent, shared = self._find_parent(req)
        if parent is None or shared <= 0:
            return req.tokens_held
        bt = self.strategy.block_tokens
        start = (shared if shared < req.tokens_held
                 else ((req.tokens_held - 1) // bt) * bt)
        return req.tokens_held - start

    # ---------------- admission ----------------
    def _free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self.running]

    def _admit(self) -> None:
        free = self._free_slots()
        # the strategy IS the admission view: per-pool-class footprints,
        # grantable leases (speculative blocks credited as free, so the
        # prefetch schedule stays decision-identical to drain()),
        # growing classes for the watermark, per-tenant quota headroom
        plan = self.sched.plan_admissions(len(free), self.strategy,
                                          num_running=len(self.running))
        for req in plan.reject:
            # over-quota: refused outright, not re-queued -- the tenant
            # must release blocks (or its quota must be raised) first
            req.state = "rejected"
            req.t_done = time.perf_counter()
            self.done.append(req)
            self.rejections += 1
        for req in plan.resume:
            slot = free.pop(0)
            if self.strategy.is_prefetched(req.rid):
                # the background h2d lane already reallocated (and maybe
                # scattered) this candidate: committing skips the
                # synchronous swap-in entirely.  A completed prefetch is
                # a HIT (resume latency fully hidden); a still-pending
                # one is promoted to the urgent lane and rides this
                # step's normal dispatch.  The byte ledger syncs through
                # the queue's commit re-notification, not engine glue.
                _, completed = self.strategy.commit_prefetch(req.rid)
                if completed:
                    self.prefetch_hits += 1
            else:
                # migrate("device") reallocates AND enqueues the h2d
                # scatter plan; the payload lands when the step loop
                # dispatches the queue (before any decode read)
                self.strategy.swap_in(req.rid)
            self._next_tok[slot] = req.pending_tok
            self._place(req, slot)
        batch: List[Tuple[int, Request, int]] = []
        suffix: List[Tuple[int, Request, int]] = []
        for req in plan.admit:
            slot = free.pop(0)
            parent, shared = self._find_parent(req)
            if parent is not None:
                self.strategy.fork(parent, req.rid, shared, req.tenant)
                self.strategy.extend(req.rid, len(req.prompt))
                self.prefix_hits += 1
            else:
                self.strategy.admit(req.rid, len(req.prompt), req.tenant)
                shared = 0
            self._place(req, slot)
            # forked children with a cached prefix take the suffix-only
            # path (attend through the shared blocks, recompute nothing)
            if shared > 0 and self.suffix_prefill:
                suffix.append((slot, req, shared))
            else:
                batch.append((slot, req, shared))
        if batch:
            self._batched_prefill(batch)
        if suffix:
            self._suffix_prefill(suffix)

    def _place(self, req: Request, slot: int) -> None:
        req.state = "running"
        req.slot = slot
        self.running[slot] = req
        self._register_prefix(req)
        # every placement path (admit, resume, fork, swap-in commit)
        # lands here: the slot's device rows and its host-written next
        # token are stale
        self.strategy.mark_dirty(slot)
        self._tok_dirty = True

    def _batched_prefill(self, batch: List[Tuple[int, Request, int]]) -> None:
        """ONE padded prefill call for all of this step's admissions.

        The strategy owns padding, table/row construction and the KV or
        state writes; the engine owns the clock and the billing: the
        scheduler's admission budget EWMA sees the tokens the strategy
        actually computed, and TTFT ends at the prefill's argmax."""
        t0 = time.perf_counter()
        nxt, billed = self.strategy.prefill(self.params, batch)
        t1 = time.perf_counter()
        self.phase_time["prefill"] += t1 - t0
        self.sched.observe_prefill(billed, t1 - t0)
        for row, (slot, req, _) in enumerate(batch):
            self._next_tok[slot] = nxt[row]
            if req.t_first < 0:
                # the first token IS the prefill's argmax: TTFT ends here
                req.t_first = t1
        self.prefill_tokens += billed

    def _suffix_prefill(self, batch: List[Tuple[int, Request, int]]) -> None:
        """ONE padded suffix-only prefill call for this step's forked
        admissions.  Bills ONLY the suffix: the admission budget's EWMA
        and the token counters see the work actually done, and the
        skipped prefix is the headline savings metric."""
        t0 = time.perf_counter()
        nxt, suffix_tokens, saved = self.strategy.prefill_suffix(
            self.params, batch)
        t1 = time.perf_counter()
        self.phase_time["prefill"] += t1 - t0
        self.sched.observe_prefill(suffix_tokens, t1 - t0)
        for row, (slot, req, _) in enumerate(batch):
            self._next_tok[slot] = nxt[row]
            if req.t_first < 0:
                req.t_first = t1
        self.prefill_tokens += suffix_tokens
        self.prefill_tokens_saved += saved

    # ---------------- preemption / swap-out ----------------
    def _preempt_slot(self, slot: int) -> None:
        req = self.running.pop(slot)
        req.pending_tok = int(self._next_tok[slot])
        # migrate("host") frees the ids and enqueues the d2h plan; the
        # allocator HOLDS the vacated ids until the gather is
        # dispatched, so reuse cannot clobber the payload mid-flight,
        # and the host copy overlaps the next decode (fence at N+1).
        self.strategy.swap_out(req.rid)
        self._deregister_prefix(req)
        req.slot = -1
        self.sched.on_preempt(req)
        self.preemptions += 1

    def preempt_latest(self) -> None:
        """Swap out the most recently ADMITTED running request (LIFO).

        The victim is keyed on ``admit_order`` -- the scheduler's
        monotonic admission stamp -- not on ``rid`` (submission order):
        a request submitted first but resumed last is still the first
        evicted.  The swap-out gather dispatches immediately (we are
        between steps); its host copy lands at the next step's fence,
        overlapping whatever decodes in between.
        """
        if not self.running:
            return
        self._preempt_slot(self.sched.pick_victim(self.running))
        self.transfers.dispatch()

    def _reclaim_for_pressure(self, requester) -> Optional[int]:
        """Arena reclaimer: cancel speculation first, then evict the
        LIFO victim; returns the reclaimed owner id.

        Called by ``Arena._alloc_ids`` when a lease request cannot be
        granted; the Arena keeps asking until the request fits or the
        victim IS the requester (surfaced to the caller as
        ``LeaseRevokedError``).  Uncommitted prefetches are the
        CHEAPEST victims -- cancelling one frees its blocks without
        moving a byte (the host payload is still authoritative), and it
        restores exactly the free-block state the no-speculation
        schedule would have had, so pressure behavior stays
        decision-identical to the ``drain()`` fallback.
        """
        spec = self.strategy.prefetched_ids()
        if spec:
            # likelihood-ordered: the scheduler's resume window ranks
            # candidates by resume order, so cancel the LEAST likely
            # speculation first -- the top-of-window prefetch (the next
            # actual resume) is the last to be withdrawn
            order = {req.rid: i
                     for i, req in enumerate(self.sched.resume_candidates())}
            rid = max(spec, key=lambda r: order.get(r, len(order)))
            self.strategy.cancel_prefetch(rid)
            self.prefetch_cancels += 1
            return rid
        if not self.running:
            return None
        slot = self.sched.pick_victim(self.running)
        rid = self.running[slot].rid
        self._preempt_slot(slot)
        return rid

    # ---------------- device-state sync ----------------
    def _sync_device_state(self) -> None:
        """Derive the strategy's device tables/rows from host truth each
        step.  This is the READ BARRIER: the decode gathers every table
        or row entry, so every running mapping must be settled (no lease
        still the target of an unfenced transfer) -- the strategy's
        ``assert_settled`` raises ``UnfencedReadError`` if the dispatch
        phase was skipped."""
        self.strategy.sync_device_state(self.running)

    # ---------------- main loop ----------------
    def _grow_for_next_token(self) -> int:
        """Ensure every running seq can write this step's token; returns
        blocks allocated (the adaptive watermark's growth signal).

        Growth allocates under Arena pressure: exhaustion triggers the
        registered reclaimer (LIFO preemption) inside the Arena; only
        when the writer ITSELF was the victim does ``LeaseRevokedError``
        surface here, and then the write is moot -- its blocks are
        already on the host tier.
        """
        grown = 0
        for slot in sorted(self.running):
            if slot not in self.running:
                continue
            req = self.running[slot]
            try:
                new = self.strategy.extend(req.rid, req.tokens_held + 1)
            except LeaseRevokedError:
                continue
            if new:
                grown += len(new)
                self.strategy.mark_dirty(slot)
        return grown

    def _cow_barrier(self) -> int:
        """Private-block guarantee for every position written this step;
        returns the number of fulfilment copies enqueued.

        The copy-target block is a DEFERRED claim the admission check
        could not reserve (a forked child is charged its worst case but
        allocates nothing while sharing).  The barrier is Arena policy
        (``Mapping.ensure_writable`` allocates the target under
        pressure, falling back to LIFO preemption inside the Arena, and
        ENQUEUES the fulfilment copy on the transfer plane); the queue
        preserves enqueue order, so a preemption gather later in the
        same pass reads settled blocks once dispatched.  Disciplines
        that never share return None unconditionally.
        """
        copies = 0
        for slot in sorted(self.running):
            if slot not in self.running:
                continue
            req = self.running[slot]
            try:
                plan = self.strategy.ensure_writable(req.rid,
                                                     req.tokens_held)
            except LeaseRevokedError:
                continue            # the writer itself was reclaimed
            if plan is not None:
                self.cow_copies += 1
                copies += 1
                # fulfilment swapped a fresh private block under the
                # shared position -- the slot's table row changed
                self.strategy.mark_dirty(slot)
        return copies

    # ---------------- compaction (Arena defrag) ----------------
    def compact_now(self) -> int:
        """One Arena ``compact()`` cycle over every pool class the
        strategy serves: move live blocks to the dense prefix; the copy
        plans ride the transfer plane and are dispatched IMMEDIATELY
        (they would launch before the decode anyway, and their holds on
        the vacated sources must not leak into this step's admission
        arithmetic -- the eager fallback releases them inside the
        enqueue's drain, so the overlapped schedule must match or the
        two diverge on marginal admissions).

        Safe between steps (no writes in flight); every table built
        afterwards reads the rewritten leases, so decoding is
        token-identical across the relocation -- the paper's
        'Relocation / Migration' row.  Returns blocks moved.
        """
        moved = self.strategy.compact_now()
        self.transfers.dispatch(lanes=(URGENT,))
        return moved

    def _maybe_compact(self) -> None:
        """Defrag pass: run when free blocks are plentiful but
        table locality has degraded (Arena policy)."""
        if self.strategy.should_compact(
                min_free_frac=COMPACT_FREE_FRAC,
                frag_threshold=COMPACT_FRAG_THRESHOLD):
            self.compact_now()

    def _maybe_prefetch(self) -> None:
        """Speculative swap-in of the scheduler's LIFO resume candidate
        on the BACKGROUND h2d lane, launched just before decode so the
        scatter overlaps it -- the candidate's next resume then commits
        bookkeeping instead of waiting on a synchronous swap-in.

        The strategy guards viability (never while the candidate's
        swap-out is still in transit, never under pressure -- headroom
        must cover the watermark, and the reclaimer cancels speculation
        FIRST anyway -- never twice for the same candidate).
        """
        if not self.prefetch_enabled:
            return
        for req in self.sched.resume_candidates():
            if not self.strategy.prefetch_viable(req.rid,
                                                 self.sched.watermark):
                continue
            self.strategy.prefetch(req.rid)
            self.prefetches += 1

    def step(self) -> None:
        """One serving step, scheduled around the per-engine queues:

            fence(N-1) -> produce plans -> dispatch urgent -> prefetch
            -> dispatch background -> decode
            [d2h host copies of step N's swap-outs AND the speculative
             h2d scatter overlap this decode]

        FENCE: land step N-1's dispatched swap-out host copies (double
        buffering: dispatched at N-1, fenced here -- the d2h engine's
        completion phase).  PRODUCE: compaction policy, admissions/
        resumes (h2d plans; prefetched resumes commit instead), growth
        + COW barrier (d2d plans, growth preemptions enqueue d2h).
        DISPATCH URGENT: every engine runs its urgent lane -- d2d
        copies and h2d scatters execute, d2h gathers launch --
        everything decode will READ is settled, while the blocking host
        copies stay pending and overlap the decode below.  PREFETCH:
        the LIFO resume candidate's speculative swap-in enqueues and
        launches on the background h2d lane, overlapping the decode
        too.
        """
        t_step = time.perf_counter()
        prefill_s = self.phase_time["prefill"]
        self.transfers.complete_dispatched()
        # deadline arithmetic runs on the step counter (a deterministic
        # virtual clock), never the wall clock
        self.sched.now = float(self.steps)
        self._maybe_compact()
        self._admit()
        self.steps += 1
        if not self.running:
            self.transfers.drain()      # idle: nothing to overlap against
            return
        grown = self._grow_for_next_token()
        if not self.running:
            self.transfers.drain()
            return
        grown += self._cow_barrier()
        self.sched.observe_growth(grown)
        self.transfers.dispatch(lanes=(URGENT,))
        self._maybe_prefetch()
        self.transfers.dispatch(lanes=(BACKGROUND,))
        t_sync = time.perf_counter()
        self.phase_time["dispatch"] += (t_sync - t_step
                                        - (self.phase_time["prefill"]
                                           - prefill_s))
        uploads = 0
        if self.resident_tables:
            rows, nbytes = self.strategy.sync_device_state_delta(
                self.running)
            if rows:
                uploads += 1
        else:
            self._sync_device_state()
            rows, nbytes = self.strategy.full_sync_cost()
            uploads += 1
        self.table_rows_updated += rows
        self.table_sync_bytes += nbytes
        t0 = time.perf_counter()
        self.phase_time["sync"] += t0 - t_sync
        if self.resident_tables:
            if self._tok_dirty or self._tok_dev is None:
                tok_dev = torch.as_tensor(self._next_tok,
                                          device=self.device)
                self._tok_dirty = False
                uploads += 1
            else:
                # steady state: this step's inputs ARE last step's
                # argmax, still latched on device -- zero uploads
                tok_dev = self._tok_dev
            nxt_dev = self.strategy.decode_resident(self.params, tok_dev)
            self._tok_dev = nxt_dev
            nxt = nxt_dev.cpu().numpy()   # the (B,) host crossing
            tokens = self._next_tok     # host truth of this step's inputs
        else:
            tokens = self._next_tok
            uploads += 1
            logits = self.strategy.decode(
                self.params, torch.as_tensor(tokens, device=self.device))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # completion
        t_retire = time.perf_counter()
        self.phase_time["decode"] += t_retire - t0
        self.host_uploads += uploads
        self.sched.observe_decode(t_retire - t0)
        # compute mark: any dispatched host copy that completes -- or
        # speculative scatter that commits -- after this point genuinely
        # overlapped a decode (honest per-engine `overlapped`)
        self.transfers.note_compute()
        self.decode_tokens += len(self.running)
        for slot, req in list(self.running.items()):
            req.generated.append(int(tokens[slot]))
            self._next_tok[slot] = nxt[slot]
            if len(req.generated) >= req.max_new or nxt[slot] == self.eos:
                req.state = "done"
                req.t_done = time.perf_counter()
                self.done.append(req)
                self.strategy.release(req.rid)
                self._deregister_prefix(req)
                del self.running[slot]
        self.phase_time["retire"] += time.perf_counter() - t_retire

    def serve(self, source=None, max_steps: int = 10_000) -> List[Request]:
        """Arrival-driven serving loop: the continuous-batching request
        plane.  Each step polls ``source`` (anything with
        ``poll(now) -> [Request]`` and ``has_more``, e.g.
        ``repro_torch.serve.traffic.RequestSource``) on the engine's step
        clock, submits whatever has arrived, and runs one ``step()`` --
        admissions and retirements happen every step, so the batch
        never drains between requests.  With nothing resident and
        nothing arrived, the step is an idle tick that only advances
        the clock toward the next arrival.  ``source=None`` serves
        exactly the pre-loaded queue (the legacy ``run()`` contract).
        """
        while self.steps < max_steps:
            if source is not None:
                for req in source.poll(float(self.steps)):
                    self.submit(req)
            if not (self.sched.has_work or self.running):
                if source is None or not source.has_more:
                    break
            self.step()
        self.transfers.drain()          # settle trailing transfers
        return self.done

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drain the pre-loaded queue (compat shim over ``serve``)."""
        return self.serve(None, max_steps)

    # ---------------- restart (checkpoint-on-arena) ----------------
    def restore_preempted(self, req: Request) -> None:
        """Re-adopt a preempted request after ``Arena.restore``.

        The arena snapshot carries the sequence's host-tier payload and
        mapping (every pool class of a composite); the caller re-creates
        the ``Request`` (rid, prompt, generated, pending_tok are
        serving-layer state) and this hooks both back together: the
        strategy adopts the restored mappings and the scheduler queues
        the request for resume.
        """
        self.strategy.adopt_restored(req.rid)
        self.sched.on_preempt(req)

    # ---------------- introspection ----------------
    @property
    def stats(self) -> Dict[str, float]:
        st = self.store.stats
        graphs = self.strategy.graph_stats
        return {
            "steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "decode_tokens": self.decode_tokens,
            "prefix_hits": self.prefix_hits,
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "rejections": self.rejections,
            "swap_outs": st.swap_outs,
            "swap_ins": st.swap_ins,
            "swap_out_bytes": st.swap_out_bytes,
            "swap_in_bytes": st.swap_in_bytes,
            "swap_by_engine": st.by_engine,
            "prefetches": self.prefetches,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_cancels": self.prefetch_cancels,
            # 0.0 (not a vacuous 1.0) when no speculation ever launched
            "prefetch_hit_rate": (self.prefetch_hits
                                  / max(self.store.stats.swap_ins, 1)
                                  if self.prefetches else 0.0),
            "pool_utilization": self.strategy.utilization,
            "resident_tables": self.resident_tables,
            "host_uploads": self.host_uploads,
            "host_uploads_per_step": (self.host_uploads
                                      / max(self.steps, 1)),
            "table_sync_bytes": self.table_sync_bytes,
            "table_rows_updated": self.table_rows_updated,
            "decode_graphs": {k: v for k, v in graphs.items()
                              if k != "prefill"},
            "prefill_graphs": graphs["prefill"],
            "phase_time_s": dict(self.phase_time),
            "compactions": self.arena.compactions,
            "blocks_compacted": self.arena.blocks_compacted,
            "watermark_effective": self.sched.watermark,
            "transfers": self.transfers.stats.to_dict(),
        }

    def arena_stats(self):
        """The unified address space's ``ArenaStats`` snapshot."""
        return self.arena.stats()

    def latency_report(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant latency percentiles over completed requests.

        TTFT is submit -> first token available (the batched prefill's
        argmax); inter-token latency is the mean decode gap
        (t_done - t_first) / (tokens - 1).  Wall-clock telemetry only
        -- nothing here feeds back into policy.  Values are
        milliseconds; percentile keys are None when a tenant finished
        no request with enough tokens to measure (rendered as "n/a"
        downstream).
        """
        samples: Dict[str, Dict[str, List[float]]] = {}
        for r in self.done:
            if r.t_submit < 0 or r.t_first < 0:
                continue
            d = samples.setdefault(r.tenant, {"ttft": [], "itl": []})
            d["ttft"].append(r.t_first - r.t_submit)
            if r.t_done >= 0 and len(r.generated) > 1:
                d["itl"].append((r.t_done - r.t_first)
                                / (len(r.generated) - 1))

        def pct(vals: List[float], q: float) -> Optional[float]:
            if not vals:
                return None
            return round(float(np.percentile(vals, q)) * 1e3, 3)

        return {tenant: {"requests": len(d["ttft"]),
                         "ttft_p50_ms": pct(d["ttft"], 50),
                         "ttft_p99_ms": pct(d["ttft"], 99),
                         "itl_p50_ms": pct(d["itl"], 50),
                         "itl_p99_ms": pct(d["itl"], 99)}
                for tenant, d in sorted(samples.items())}

    def check_consistency(self) -> None:
        """Invariant audit (used by tests after every step): engine-
        level slot bookkeeping here, pool/ledger/lease invariants
        delegated to the strategy (which checks EVERY class it serves).
        """
        for slot, req in self.running.items():
            assert req.state == "running" and req.slot == slot
        self.strategy.check_consistency(self.running)
