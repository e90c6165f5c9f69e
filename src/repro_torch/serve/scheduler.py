"""Serving policy layer: WHAT runs next, never HOW it runs.

This module is deliberately device-free (no torch imports): it decides
admissions, resumes and preemption victims from block-count arithmetic
only, and the engine executes those decisions against the pool.  The
split mirrors the paper's architecture -- a tiny software memory manager
making policy over fixed-size blocks, with mechanism (DMA, scatter,
prefill) kept elsewhere.

Policies implemented:

* **Pluggable admission order** -- the queue of not-yet-admitted
  requests is an ``AdmissionPolicy``.  The pinned default,
  ``FCFSAdmission``, serves strictly in submission order within each
  ``priority_class`` (lower class value = more urgent; everything
  defaults to class 0, which makes the default policy decision-
  identical to the pre-request-plane FCFS queue).  ``FairAdmission``
  adds per-tenant token-rate fairness via deficit round-robin: each
  backlogged tenant accrues whole quanta of token credit until some
  head-of-line request is affordable, the richest affordable tenant is
  served and charged its worst-case tokens -- a flooding tenant can
  only consume its share while another tenant is backlogged, yet a
  lone tenant is never throttled (work-conserving crediting).
* **FCFS admission with a free-block watermark** -- queued requests are
  admitted in arrival order, and only while admission leaves at least
  ``watermark`` blocks free (headroom for the per-``block_tokens``-steps
  growth of already-running sequences).  The watermark is ADAPTIVE by
  default: an EWMA of observed allocation per step (growth + COW copy
  targets, reported by the engine via ``observe_growth``) times a small
  lookahead horizon, so headroom tracks the workload instead of a
  hand-tuned constant; passing ``watermark=<int>`` overrides the
  adaptive path with the static knob.  A request is only ever admitted
  when its WORST-CASE footprint (prompt + max_new tokens) currently
  fits: blocks are handed out lazily as the sequence grows, but the
  up-front check plus LIFO preemption guarantees the oldest running
  sequence can always reclaim enough blocks to finish.
* **Deadline-cost preemption with a LIFO fallback** -- the victim is
  the running request whose eviction does the least SLO damage: the
  one with the MOST deadline slack (``deadline - now - remaining
  decode steps``), ties broken by the most recent admission.  Requests
  without a deadline have infinite slack, so with no deadlines
  configured the choice degenerates EXACTLY to the existing LIFO rule
  -- the most recently *admitted* request (``admit_order``, a
  monotonic counter stamped on every admission including resumes --
  NOT the request id, which is submission order).  Newest-first
  eviction is what makes the progress argument above work; the
  engine advances ``Scheduler.now`` (its step counter, a deterministic
  virtual clock) so deadline arithmetic never reads the wall clock.
* **Chunked/batched prefill budgeting** -- each step admits at most
  ``prefill_budget`` prompt tokens (the engine prefills all of a step's
  admissions in ONE padded batched call), bounding per-step latency
  spikes.  The budget never blocks the first admission of an otherwise
  idle engine.  ``prefill_budget="auto"`` derives the budget from an
  EWMA of MEASURED prefill latency (the same adapt-with-knob-override
  pattern as the watermark): the engine reports seconds-per-prefill-
  token and seconds-per-decode-step (``observe_prefill`` /
  ``observe_decode``), and the budget is sized so one step's prefill
  takes at most ``prefill_slack`` decode-steps' worth of wall time.
  ``"auto"`` is the DEFAULT: wall-clock-derived policy is not
  deterministic across runs, so schedule-equivalence pins compare
  per-request tokens (never step counts) and pass an explicit
  ``prefill_budget=None`` where they need the unthrottled schedule;
  the integer knob remains the static override.

Resumed requests are preferred over new ones and pop LIFO off a
``BlockStack`` (the paper's split stack backing a runtime structure).
They carry their saved KV payload, so they cost no prefill budget --
and ``resume_candidates()`` exposes the LIFO head to the engine so the
transfer plane can PREFETCH its swap-in on the background h2d lane
while decode runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.stack import BlockStack
from repro_torch.mem import Arena


class PoolGroupMismatchError(RuntimeError):
    """A fork's parent lives in a different dp pool group than the child.

    With ``dp_groups > 1`` block tables hold GROUP-LOCAL ids: aliasing a
    parent block from another group would silently address a different
    physical block in the child's pool range, corrupting both tables.
    Admission rejects the fork loudly instead.
    """


def slot_group(slot: int, slots: int, dp_groups: int) -> int:
    """Pool group of a batch slot: slots split into dp_groups contiguous
    ranges, co-sharded with the pool's block dim (see PagedKVConfig)."""
    return slot * dp_groups // slots


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,)
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"              # queued|running|preempted|done
    slot: int = -1
    admit_order: int = -1              # monotonic admission stamp (LIFO key)
    pending_tok: int = -1              # next input token saved at preemption
    # ---- request plane (multi-tenant streaming admission) ----
    tenant: str = "default"            # FairAdmission's fairness domain
    arrival_time: float = 0.0          # virtual (engine-step) arrival clock
    deadline: Optional[float] = None   # SLO, same clock; None = best effort
    priority_class: int = 0            # lower = more urgent (0 = default)
    # wall-clock latency telemetry (perf_counter seconds; stamped by the
    # engine, never read by policy -- policy clocks are virtual)
    t_submit: float = -1.0
    t_first: float = -1.0              # first token available (prefill done)
    t_done: float = -1.0

    @property
    def tokens_held(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def max_tokens(self) -> int:
        """Worst-case footprint in tokens (prompt + full generation)."""
        return len(self.prompt) + self.max_new

    def slack(self, now: float) -> float:
        """Deadline headroom at virtual time ``now``: time left minus
        the decode steps still owed.  Infinite without a deadline, so
        no-deadline workloads sort purely by the LIFO stamp."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - now - (self.max_new - len(self.generated))


class AdmissionPolicy:
    """Order over queued (never-yet-admitted) requests.

    The scheduler only ever looks at the head (``peek``) and consumes
    it (``pop``); a policy is free to reorder between calls but must
    return from ``pop`` exactly what ``peek`` showed, with no state
    change on ``peek`` -- ``plan_admissions`` peeks to negotiate block
    leases and pops only when the candidate actually fits.
    """

    def push(self, req: Request) -> None:
        raise NotImplementedError

    def peek(self) -> Optional[Request]:
        raise NotImplementedError

    def pop(self) -> Request:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def snapshot(self) -> List[Request]:
        """All queued requests, in the policy's current service order
        (introspection only -- compat surface for ``Scheduler.queue``)."""
        raise NotImplementedError


class FCFSAdmission(AdmissionPolicy):
    """Priority-bucketed FCFS: strict submission order within each
    ``priority_class``, lower class first.  With every request in the
    default class 0 this is EXACTLY the pre-request-plane FIFO list --
    the pinned default policy."""

    def __init__(self):
        self._queue: List[Request] = []          # submission order

    def push(self, req: Request) -> None:
        self._queue.append(req)

    @staticmethod
    def _key(req: Request, i: int) -> Tuple:
        # EDF within each priority class: (class, deadline, submission
        # index).  A request without a deadline sorts at +inf, so an
        # all-best-effort queue reduces EXACTLY to (class, index) -- the
        # pre-EDF order, and with all-zero classes to index 0, the
        # original queue[0].
        return (req.priority_class,
                req.deadline if req.deadline is not None else float("inf"),
                i)

    def _head_idx(self) -> int:
        return min(range(len(self._queue)),
                   key=lambda i: self._key(self._queue[i], i))

    def peek(self) -> Optional[Request]:
        return self._queue[self._head_idx()] if self._queue else None

    def pop(self) -> Request:
        return self._queue.pop(self._head_idx())

    def __len__(self) -> int:
        return len(self._queue)

    def snapshot(self) -> List[Request]:
        idx = sorted(range(len(self._queue)),
                     key=lambda i: self._key(self._queue[i], i))
        return [self._queue[i] for i in idx]


class FairAdmission(AdmissionPolicy):
    """Per-tenant token-rate fairness via deficit round-robin.

    Every tenant owns a FIFO queue and a token-deficit counter.  When a
    candidate is needed, all BACKLOGGED tenants are credited the least
    number of whole ``quantum``-token rounds that makes some head
    request affordable (work conservation: a lone tenant is never
    throttled, and credit only accrues while competing work exists);
    the affordable tenant with the largest resulting deficit is served
    and charged the request's WORST-CASE tokens (``max_tokens`` -- the
    same currency the admission block gate reasons in).  Ties break by
    tenant registration order, so the schedule is deterministic.  A
    tenant's deficit resets when its queue empties -- saved-up credit
    must not buy a later flood.
    """

    def __init__(self, quantum: int = 32):
        if quantum <= 0:
            raise ValueError("quantum must be positive")
        self.quantum = quantum
        self._tenants: Dict[str, List[Request]] = {}   # registration order
        self.deficit: Dict[str, float] = {}

    def push(self, req: Request) -> None:
        self._tenants.setdefault(req.tenant, [])
        self.deficit.setdefault(req.tenant, 0.0)
        self._tenants[req.tenant].append(req)

    @staticmethod
    def _cost(req: Request) -> int:
        return max(1, req.max_tokens)

    def _select(self) -> Optional[Tuple[str, int]]:
        """(tenant to serve, quanta to credit) -- pure, no mutation."""
        backlogged = [t for t, q in self._tenants.items() if q]
        if not backlogged:
            return None
        rounds = min(
            max(0, -(-int(self._cost(self._tenants[t][0])
                          - self.deficit[t]) // self.quantum))
            for t in backlogged)
        order = {t: i for i, t in enumerate(self._tenants)}
        afford = [t for t in backlogged
                  if self.deficit[t] + rounds * self.quantum
                  >= self._cost(self._tenants[t][0])]
        best = max(afford, key=lambda t: (self.deficit[t]
                                          + rounds * self.quantum,
                                          -order[t]))
        return best, rounds

    def peek(self) -> Optional[Request]:
        sel = self._select()
        return self._tenants[sel[0]][0] if sel else None

    def pop(self) -> Request:
        tenant, rounds = self._select()
        if rounds:
            for t, q in self._tenants.items():
                if q:
                    self.deficit[t] += rounds * self.quantum
        req = self._tenants[tenant].pop(0)
        self.deficit[tenant] -= self._cost(req)
        if not self._tenants[tenant]:
            self.deficit[tenant] = 0.0
        return req

    def __len__(self) -> int:
        return sum(len(q) for q in self._tenants.values())

    def snapshot(self) -> List[Request]:
        return [r for q in self._tenants.values() for r in q]


@dataclasses.dataclass
class StepPlan:
    """One step's admission decisions, in execution order."""
    resume: List[Request] = dataclasses.field(default_factory=list)
    admit: List[Request] = dataclasses.field(default_factory=list)
    #: popped candidates whose tenant is over its block quota -- never
    #: admitted; the engine finishes them with state="rejected"
    reject: List[Request] = dataclasses.field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.resume or self.admit)


class Scheduler:
    """Policy-only continuous-batching scheduler (see module docstring)."""

    #: pool class for the scheduler's own runtime structures (the
    #: preempted-LIFO BlockStack) when it shares the engine's Arena
    META_CLASS = "sched-meta"

    def __init__(self, *, watermark: Optional[int] = None,
                 prefill_budget="auto",
                 policy: Optional[AdmissionPolicy] = None,
                 arena: Optional[Arena] = None,
                 growth_alpha: float = 0.25, growth_horizon: int = 4,
                 latency_alpha: float = 0.25, prefill_slack: int = 4):
        if watermark is not None and watermark < 0:
            raise ValueError("watermark must be >= 0")
        if not (prefill_budget is None or prefill_budget == "auto"):
            if not isinstance(prefill_budget, int) or prefill_budget <= 0:
                raise ValueError(
                    "prefill_budget must be a positive int, 'auto', or "
                    "None")
        if not 0.0 < growth_alpha <= 1.0:
            raise ValueError("growth_alpha must be in (0, 1]")
        if not 0.0 < latency_alpha <= 1.0:
            raise ValueError("latency_alpha must be in (0, 1]")
        if prefill_slack <= 0:
            raise ValueError("prefill_slack must be positive")
        #: static override; None selects the adaptive EWMA watermark
        self.watermark_override = watermark
        self.growth_alpha = growth_alpha
        self.growth_horizon = growth_horizon
        self._growth_ewma = 0.0
        #: int = static budget, "auto" = derived from measured latency,
        #: None = unlimited
        self.prefill_budget_override = (prefill_budget
                                        if isinstance(prefill_budget, int)
                                        else None)
        self.prefill_auto = prefill_budget == "auto"
        self.latency_alpha = latency_alpha
        self.prefill_slack = prefill_slack
        self._prefill_spt_ewma = 0.0   # seconds per prefill token
        self._decode_s_ewma = 0.0      # seconds per decode step
        #: admission order over queued arrivals (FCFS pinned default)
        self.policy = policy if policy is not None else FCFSAdmission()
        #: virtual clock for deadline arithmetic -- the engine writes
        #: its step counter here; policy never reads the wall clock
        self.now = 0.0
        #: optional hook: Request -> prefill tokens actually computed.
        #: The engine points this at its suffix-prefill cost (a forked
        #: child bills only its un-cached suffix against the budget);
        #: None bills the whole prompt.
        self.prefill_cost_fn = None
        if arena is not None:
            # scheduler scratch rides the same address space as the KV
            # pool -- NOTHING in the runtime asks for contiguous memory
            arena.register_class(self.META_CLASS, num_blocks=4096,
                                 block_nbytes=256 * 8)
            self.preempted = BlockStack(block_size=256, arena=arena,
                                        pool_class=self.META_CLASS,
                                        owner="scheduler.preempted")
        else:
            self.preempted = BlockStack(block_size=256)  # LIFO resume order
        self._admit_counter = 0

    # ---------------- adaptive watermark ----------------
    @property
    def watermark(self) -> int:
        """Free-block headroom demanded beyond each admission.

        Static when the constructor knob was given; otherwise derived
        from the observed allocation rate: ``ceil(EWMA(blocks/step) *
        growth_horizon)`` -- enough free blocks for the running set to
        keep growing for ``growth_horizon`` steps while the next
        admission's worst case is reserved.
        """
        if self.watermark_override is not None:
            return self.watermark_override
        return int(np.ceil(self._growth_ewma * self.growth_horizon))

    def observe_growth(self, blocks: int) -> None:
        """Engine feedback: blocks allocated for growth + COW targets
        this step (drives the adaptive watermark)."""
        a = self.growth_alpha
        self._growth_ewma = (1 - a) * self._growth_ewma + a * max(0, blocks)

    # ---------------- adaptive prefill budget ----------------
    @property
    def prefill_budget(self) -> Optional[int]:
        """Per-step prompt-token budget (None = unlimited).

        Static when the constructor knob was an int; with ``"auto"``,
        derived from measured latency: enough tokens that one step's
        prefill costs at most ``prefill_slack`` decode-steps of wall
        time (``prefill_slack * EWMA(s/decode-step) /
        EWMA(s/prefill-token)``).  Unlimited until both EWMAs have
        observations -- the first admission is never blocked.
        """
        if not self.prefill_auto:
            return self.prefill_budget_override
        if self._prefill_spt_ewma <= 0.0 or self._decode_s_ewma <= 0.0:
            return None
        return max(1, int(self.prefill_slack * self._decode_s_ewma
                          / self._prefill_spt_ewma))

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        """Engine feedback: one batched prefill of ``tokens`` prompt
        tokens took ``seconds`` (drives the auto prefill budget)."""
        if tokens <= 0 or seconds <= 0.0:
            return
        a = self.latency_alpha
        spt = seconds / tokens
        self._prefill_spt_ewma = ((1 - a) * self._prefill_spt_ewma + a * spt
                                  if self._prefill_spt_ewma > 0.0 else spt)

    def observe_decode(self, seconds: float) -> None:
        """Engine feedback: one decode step took ``seconds``."""
        if seconds <= 0.0:
            return
        a = self.latency_alpha
        self._decode_s_ewma = ((1 - a) * self._decode_s_ewma + a * seconds
                               if self._decode_s_ewma > 0.0 else seconds)

    # ---------------- intake ----------------
    def submit(self, req: Request) -> None:
        req.state = "queued"
        self.policy.push(req)

    def on_preempt(self, req: Request) -> None:
        req.state = "preempted"
        self.preempted.push(req)

    @property
    def queue(self) -> List[Request]:
        """Queued (never admitted) requests in service order -- a
        snapshot view over the admission policy (compat surface)."""
        return self.policy.snapshot()

    @property
    def has_work(self) -> bool:
        return len(self.policy) > 0 or len(self.preempted) > 0

    #: speculative resume window: how deep into the preempted stack the
    #: prefetcher may look (top-k, most-likely-next first)
    prefetch_window = 2

    def resume_candidates(self) -> List[Request]:
        """The LIFO resume candidates, most-likely-next first (top-k
        window, ``prefetch_window`` deep).

        This is the policy surface the speculative prefetch rides: the
        head of the preempted stack is the next sequence a freed slot
        will resume and the second entry follows it, so the engine can
        enqueue their swap-ins on the background h2d lane WHILE decode
        runs and commit (or cancel) them when the admission decision
        actually lands.  The ordering doubles as the cancellation
        likelihood ranking under pressure: entries deeper in the window
        are withdrawn first.  Peeking never changes scheduling state.
        """
        return self.preempted.peek_n(self.prefetch_window)

    # ---------------- admission ----------------
    def _stamp(self, req: Request) -> Request:
        req.admit_order = self._admit_counter
        self._admit_counter += 1
        return req

    def plan_admissions(self, free_slots: int, mem,
                        num_running: int) -> StepPlan:
        """Pop as many candidates as policy allows this step.

        ``mem`` is the lease-negotiation view (PagedKVManager or
        anything with ``blocks_needed(tokens)`` and ``free_blocks`` --
        the number of leases the shared Arena can grant right now;
        legacy stubs exposing ``allocator.num_free`` still work).
        Candidates are considered strictly in order (resumes LIFO first,
        then the FCFS queue head); the first one that does not fit ends
        admission -- no queue jumping, so admission order equals
        completion-pressure order.

        A strategy view exposing ``footprint(req)`` (per-pool-class
        block dict) takes the VECTOR path instead: the same loop over a
        dict of per-class free counts, the watermark applied only to
        classes the strategy declares growing (a constant-state class's
        footprint is exact, so no headroom is reserved for it), plus
        per-tenant quota enforcement -- over-quota candidates are popped
        onto ``StepPlan.reject`` instead of blocking the head of line.
        """
        if hasattr(mem, "footprint"):
            return self._plan_admissions_vector(free_slots, mem,
                                                num_running)
        plan = StepPlan()
        free = getattr(mem, "free_blocks", None)
        if free is None:                     # legacy accounting stubs
            free = mem.allocator.num_free
        budget = self.prefill_budget
        while free_slots > 0:
            from_preempted = len(self.preempted) > 0
            cand: Request = (self.preempted.peek() if from_preempted
                             else self.policy.peek())
            if cand is None:
                break
            need = mem.blocks_needed(cand.max_tokens)
            busy = num_running > 0 or bool(plan)
            if need > free:
                break                    # worst-case footprint must fit
            if busy and free - need < self.watermark:
                break                    # keep growth headroom
            # suffix-only prefill: the cost hook bills just the tokens
            # the engine will actually compute (a forked child's
            # un-cached suffix).  Plan-time lookup runs BEFORE this
            # step's other admissions register their prefixes, so the
            # estimate can only err high -- never over-admits.
            cost = (0 if from_preempted
                    else self.prefill_cost_fn(cand) if self.prefill_cost_fn
                    else cand.tokens_held)
            if busy and budget is not None and cost > budget:
                break                    # prefill chunking
            if from_preempted:
                self.preempted.pop()
                plan.resume.append(self._stamp(cand))
            else:
                self.policy.pop()
                plan.admit.append(self._stamp(cand))
            free -= need
            if budget is not None:
                budget = max(0, budget - cost)
            free_slots -= 1
        return plan

    def _plan_admissions_vector(self, free_slots: int, mem,
                                num_running: int) -> StepPlan:
        """Per-pool-class admission against a strategy view (see
        ``plan_admissions``).  Byte-for-byte the scalar loop when the
        strategy has one growing class and no quotas."""
        plan = StepPlan()
        free = {c: int(n) for c, n in mem.free_by_class().items()}
        growing = frozenset(getattr(mem, "growing_classes", free))
        budget = self.prefill_budget
        planned: Dict[Tuple[str, str], int] = {}
        while free_slots > 0:
            from_preempted = len(self.preempted) > 0
            cand: Request = (self.preempted.peek() if from_preempted
                             else self.policy.peek())
            if cand is None:
                break
            need = mem.footprint(cand)
            if not from_preempted and hasattr(mem, "quota_headroom"):
                room = mem.quota_headroom(cand.tenant)
                if any(room.get(c, float("inf"))
                       - planned.get((cand.tenant, c), 0) < n
                       for c, n in need.items()):
                    # over-quota: reject rather than stall the queue --
                    # a quota violation never resolves by waiting
                    self.policy.pop()
                    plan.reject.append(cand)
                    continue
            busy = num_running > 0 or bool(plan)
            if any(n > free.get(c, 0) for c, n in need.items()):
                break                    # worst-case footprint must fit
            if busy and any(c in growing
                            and free.get(c, 0) - n < self.watermark
                            for c, n in need.items()):
                break                    # growth headroom (growing only)
            cost = (0 if from_preempted
                    else self.prefill_cost_fn(cand) if self.prefill_cost_fn
                    else cand.tokens_held)
            if busy and budget is not None and cost > budget:
                break                    # prefill chunking
            if from_preempted:
                self.preempted.pop()
                plan.resume.append(self._stamp(cand))
            else:
                self.policy.pop()
                plan.admit.append(self._stamp(cand))
            for c, n in need.items():
                free[c] = free.get(c, 0) - n
                key = (cand.tenant, c)
                planned[key] = planned.get(key, 0) + n
            if budget is not None:
                budget = max(0, budget - cost)
            free_slots -= 1
        return plan

    # ---------------- preemption ----------------
    def pick_victim(self, running: Dict[int, Request]) -> int:
        """Slot whose eviction does the least SLO damage.

        Deadline-cost rule: evict the request with the MOST deadline
        slack at the current virtual time (``Request.slack`` -- time
        left minus decode steps owed), ties broken by the most recent
        admission.  Requests without deadlines have infinite slack, so
        with no deadlines configured this is EXACTLY the original LIFO
        rule -- the max ``admit_order`` -- which keeps the LIFO
        schedule pins decision-identical.  Keyed on ``admit_order``, not
        rid: a resumed request that was submitted early but re-admitted
        late is still evicted before older residents.
        """
        if not running:
            raise ValueError("no running requests to preempt")
        return max(running, key=lambda s: (running[s].slack(self.now),
                                           running[s].admit_order))

    # ---------------- fork admission (dp pool groups) ----------------
    @staticmethod
    def validate_fork(parent_slot: int, child_slot: int, slots: int,
                      dp_groups: int) -> None:
        """Admission gate for COW forks under data-parallel pool groups.

        Block tables hold group-local ids when ``dp_groups > 1``, so a
        child may only alias a parent resident in ITS OWN pool group;
        anything else must fail loudly (silent aliasing across groups
        corrupts both tables).  No-op for the common dp_groups == 1.
        """
        if dp_groups <= 1:
            return
        pg = slot_group(parent_slot, slots, dp_groups)
        cg = slot_group(child_slot, slots, dp_groups)
        if pg != cg:
            raise PoolGroupMismatchError(
                f"fork parent in pool group {pg} (slot {parent_slot}) "
                f"but child in group {cg} (slot {child_slot}); "
                f"cross-group aliasing of group-local block ids would "
                f"corrupt both tables")
