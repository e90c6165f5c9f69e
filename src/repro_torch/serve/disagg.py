"""Serving across engines over the migratable Arena: prefill/decode
disaggregation and live engine migration.

Counterpart of ``repro.serve.disagg``.  Both halves are the serving-layer
face of one mem-layer fact (``repro_torch.mem.migrate``): because every
payload move is a transfer-plane plan and every table an id-indirected
``Mapping``, a sequence's cache -- or a whole engine's address space --
can change engines without any new device mechanism.

**Prefill/decode disaggregation.**  A ``PrefillWorker`` runs prompt
prefill on its own engine (own arena, own pools), then deposits the
finished sequence's blocks as ``BlockBundle``s (one per pool class); a
``DecodeWorker`` adopts the bundles onto fresh blocks of the decode
engine's arena (a scatter into its pools, in place, so the decode
engine's captured graphs keep their addresses) and places the request
directly into a decode slot -- never re-running prefill.
``DisaggregatedEngine`` is the front-end: it polls the arrival source on
the decode engine's step clock, keeps the admission footprint gate and
the latency stamps (``t_submit`` at intake, ``t_first`` at the prefill
argmax), and hands each prompt prefill -> handoff -> decode.

**Live migration.**  ``migrate_live`` drives the mem layer's
``MigrationSession`` against a serving engine: pre-copy rounds overlap
decode steps, the dirty set converges to the running working set, and
the stop-and-copy pause re-gathers only that tail before one
``Arena.snapshot``.  ``capture_request_plane``/``resume_engine`` move
the request-plane state (running slots, next-token latches, queued and
preempted requests, the admission stamp counter and the step clock) so
the destination engine resumes every in-flight request.  The next-token
latch is read from the host truth (``Engine._next_tok``) and written
back before ``_place``, which marks the device copy stale, so the
destination's first step uploads the carried tokens.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from repro_torch.mem.migrate import (BlockBundle, MigrationSession,
                                     adopt_payload, export_mapping)
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

__all__ = ["PrefillWorker", "DecodeWorker", "DisaggregatedEngine",
           "capture_request_plane", "resume_engine", "migrate_live"]


class PrefillWorker:
    """The prefill side of the disaggregated pair: its own engine
    (own arena and pools) runs each prompt's padded prefill, then
    exports the finished sequence's blocks as transferable bundles.
    ``slots=1`` -- the worker never decodes, it only needs prefill
    tables."""

    def __init__(self, model, params, *, max_seq: int, num_blocks: int,
                 pool_prefix: str = "", **engine_kw):
        engine_kw.setdefault("share_prefixes", False)
        engine_kw.setdefault("prefetch", False)
        self.engine = Engine(model, params, slots=1, max_seq=max_seq,
                             num_blocks=num_blocks,
                             pool_prefix=pool_prefix, **engine_kw)
        self.prefills = 0

    def prefill_one(self, req: Request) -> Tuple[int, List[BlockBundle]]:
        """Prefill ``req``'s prompt and hand its cache over: returns the
        first generated token (the prefill argmax -- TTFT ends here) and
        one ``BlockBundle`` per pool class.  The worker's blocks are
        released back to its own pool by the export."""
        eng = self.engine
        eng.strategy.admit(req.rid, len(req.prompt), req.tenant)
        t0 = time.perf_counter()
        nxt, billed = eng.strategy.prefill(eng.params, [(0, req, 0)])
        t1 = time.perf_counter()
        eng.sched.observe_prefill(billed, t1 - t0)
        eng.prefill_tokens += billed
        if req.t_first < 0:
            req.t_first = t1       # first token IS the prefill's argmax
        bundles = [export_mapping(eng.arena, mgr.disown(req.rid))
                   for mgr in eng.strategy.managers()]
        self.prefills += 1
        return int(nxt[0]), bundles


class DecodeWorker:
    """The decode side: adopts handed-off bundles onto the decode
    engine's arena and places the request directly into a slot (no
    admission prefill -- the first token already exists)."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def adopt(self, req: Request, bundles: List[BlockBundle],
              first_tok: int, slot: Optional[int] = None) -> int:
        eng = self.engine
        if slot is None:
            slot = eng._free_slots()[0]
        # bundle order follows the source strategy's pool_classes;
        # remap positionally so prefill/decode pool prefixes may differ
        for bundle, cls in zip(bundles, eng.strategy.pool_classes):
            adopt_payload(eng.arena, req.rid, bundle, pool_class=cls)
        eng.strategy.adopt_device(req.rid)
        eng.sched._stamp(req)          # LIFO/admission stamp for victims
        eng._next_tok[slot] = first_tok
        eng._place(req, slot)
        return slot


class DisaggregatedEngine:
    """Front-end over a (prefill worker, decode engine) pair.

    ``serve(source)`` keeps the continuous-batching contract of
    ``Engine.serve``: arrivals are polled on the DECODE engine's step
    clock, ``t_submit`` is stamped at intake, and each step first hands
    off as many backlogged prompts as the decode side can admit
    (worst-case per-pool-class footprint must fit, exactly the
    monolithic admission gate), then runs one decode step.  Requests
    the decode engine later preempts resume through its normal
    swap-in path -- disaggregation only moves PREFILL off-engine.
    """

    def __init__(self, prefill: PrefillWorker, decode: Engine):
        self.prefill = prefill
        self.decode = DecodeWorker(decode)
        self.backlog: List[Request] = []
        self.handoffs = 0
        self.handoff_bytes = 0

    @property
    def engine(self) -> Engine:
        return self.decode.engine

    @property
    def done(self) -> List[Request]:
        return self.engine.done

    def submit(self, req: Request) -> None:
        if req.t_submit < 0:
            req.t_submit = time.perf_counter()
        self.backlog.append(req)

    def _admit_backlog(self) -> None:
        eng = self.engine
        free = eng._free_slots()
        while self.backlog and free:
            req = self.backlog[0]
            need = eng.strategy.footprint(req)
            avail = eng.strategy.free_by_class()
            if any(n > avail.get(c, 0) for c, n in need.items()):
                break              # worst case must fit, as everywhere
            self.backlog.pop(0)
            first, bundles = self.prefill.prefill_one(req)
            self.decode.adopt(req, bundles, first, slot=free.pop(0))
            self.handoffs += 1
            self.handoff_bytes += sum(b.nbytes for b in bundles)

    def serve(self, source=None, max_steps: int = 10_000) -> List[Request]:
        eng = self.engine
        while eng.steps < max_steps:
            if source is not None:
                for req in source.poll(float(eng.steps)):
                    self.submit(req)
            self._admit_backlog()
            if not (self.backlog or eng.running or eng.sched.has_work):
                if source is None or not source.has_more:
                    break
            eng.step()
        eng.transfers.drain()
        return eng.done

    def run(self, max_steps: int = 10_000) -> List[Request]:
        return self.serve(None, max_steps)


# ---------------------------------------------------------------------------
# live migration of a whole serving engine
# ---------------------------------------------------------------------------

def capture_request_plane(engine: Engine) -> dict:
    """Snapshot the serving-layer state the Arena checkpoint does not
    carry: running requests with their slots and next-token latches
    (the host truth, written by the last step's retire), the queued and
    preempted sets, the finished list, the step clock and the admission
    stamp counter.  DESTRUCTIVE on the preempted stack (the source
    engine is being migrated away); the returned ``preempted`` list is
    top-of-stack first."""
    preempted: List[Request] = []
    while len(engine.sched.preempted) > 0:
        preempted.append(engine.sched.preempted.pop())
    return {
        "steps": engine.steps,
        "running": {slot: (req, int(engine._next_tok[slot]))
                    for slot, req in engine.running.items()},
        "queued": list(engine.sched.queue),
        "preempted": preempted,
        "done": list(engine.done),
        "admit_counter": engine.sched._admit_counter,
    }


def resume_engine(engine: Engine, plane: dict) -> None:
    """Rebuild the request plane on a destination engine whose arena
    has been ``Arena.restore``d from a live-migration snapshot: every
    running request re-adopts its DEVICE-restored mappings and keeps
    its slot and next-token latch; preempted requests re-adopt their
    host-tier mappings and keep their LIFO order; the step clock and
    admission stamps continue, so deadline arithmetic and victim choice
    are unchanged across the move."""
    engine.steps = plane["steps"]
    engine.sched.now = float(plane["steps"])
    engine.sched._admit_counter = plane["admit_counter"]
    engine.done.extend(plane["done"])
    for req in plane["queued"]:
        engine.sched.submit(req)
    # plane stores top-first; pushing bottom-first restores LIFO order
    for req in reversed(plane["preempted"]):
        engine.restore_preempted(req)
    for slot, (req, nxt) in plane["running"].items():
        engine.strategy.adopt_device(req.rid)
        engine._next_tok[slot] = nxt
        engine._place(req, slot)


def migrate_live(src: Engine, build_dst: Callable[[], Engine], path: str,
                 *, max_rounds: int = 8
                 ) -> Tuple[Engine, MigrationSession]:
    """Incremental live migration of a serving engine.

    Pre-copy rounds run on the background d2h lane while ``src`` keeps
    decoding (one engine step per round -- the round's gathers are
    dispatched by that step's own queue schedule); once the dirty set
    converges, the engine pauses, ``finalize`` re-copies the dirty tail
    and writes the snapshot, the request plane is captured, and the
    destination engine (``build_dst()`` -- same model geometry, fresh
    arena) restores and resumes every in-flight request.  Returns
    ``(dst_engine, session)``; ``session.migration_report()`` carries
    rounds, bytes per round and the pause steps.
    """
    sess = MigrationSession(src.arena, max_rounds=max_rounds)
    while not sess.converged():
        sess.begin_round()
        if src.running or src.sched.has_work:
            src.step()       # decode overlaps this round's gathers
        sess.collect_round()
    plane = capture_request_plane(src)
    sess.finalize(path)
    dst = build_dst()
    dst.arena.restore(path)
    resume_engine(dst, plane)
    return dst, sess
