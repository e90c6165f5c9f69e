"""Arrival traces for the continuous-batching request plane.

Requests no longer pre-load a static batch: a ``RequestSource`` feeds
``Engine.serve`` arrivals keyed on the engine's STEP clock (a
deterministic virtual time -- one decode step is one tick), so a trace
is fully replayable: the same seed produces the same prompts at the
same virtual instants, and two runs decode token-identical outputs
regardless of how wall-clock-adaptive policy (the auto prefill budget)
reshuffles admission timing.

``make_trace`` generates the paper-motivated workloads -- datacenter
colocation means many tenants sharing one machine, so the shapes that
stress software admission are:

* ``poisson``   -- memoryless arrivals (exponential inter-arrival gaps),
                   the steady-state load model.
* ``bursty``    -- arrivals land in clusters with idle gaps between
                   them; stresses admission headroom and preemption.
* ``heavytail`` -- Pareto inter-arrival gaps: long quiet stretches and
                   sudden pile-ups (the "elephants and mice" shape).
* ``static``    -- everything arrives at t=0 (the legacy pre-loaded
                   batch, for equivalence pins).
* ``prefixheavy`` -- poisson arrivals where nearly every request forks
                   a shared base prompt (chatbot system prompts /
                   few-shot headers): the target shape for COW prefix
                   sharing plus suffix-only prefill.

Tenants are assigned round-robin; ``shared_frac`` mixes in a cohort
that shares block-aligned base prompts (exercising COW prefix sharing
under live traffic); ``deadline_slack`` attaches per-request SLOs for
the deadline-cost preemption policy.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import Request

__all__ = ["RequestSource", "ThreadedRequestSource", "make_trace"]

TRACE_KINDS = ("static", "poisson", "bursty", "heavytail", "prefixheavy")


class RequestSource:
    """Replayable arrival stream over a fixed trace.

    ``poll(now)`` hands out every request whose ``arrival_time`` is due
    at virtual time ``now``, in arrival order (ties by rid).  The
    engine polls once per step; a source is exhausted when
    ``has_more`` goes False.
    """

    def __init__(self, requests: Sequence[Request]):
        self._trace: List[Request] = sorted(
            requests, key=lambda r: (r.arrival_time, r.rid))
        self._idx = 0

    @property
    def has_more(self) -> bool:
        return self._idx < len(self._trace)

    def __len__(self) -> int:
        return len(self._trace) - self._idx

    def poll(self, now: float) -> List[Request]:
        out: List[Request] = []
        while (self._idx < len(self._trace)
               and self._trace[self._idx].arrival_time <= now):
            out.append(self._trace[self._idx])
            self._idx += 1
        return out


class ThreadedRequestSource:
    """Thread-fed async arrival source for ``Engine.serve``.

    A producer thread calls ``submit()`` while the engine's step loop
    polls from its own thread: the submit side is the only shared
    state, guarded by one lock, so arrivals can be generated online
    (an RPC front-end, a replay thread pacing wall-clock arrivals)
    instead of from a pre-built trace.  Requests whose
    ``arrival_time`` is in the future are held back until the engine's
    virtual clock reaches them; everything else is due at the next
    poll, in ``(arrival_time, rid)`` order for determinism.

    ``has_more`` stays True until ``close()`` -- an open source keeps
    ``serve()`` ticking idle steps while it waits for the producer, so
    the producer MUST ``close()`` (or the loop runs to ``max_steps``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: List[Request] = []
        self._closed = False

    def submit(self, req: Request) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("submit() after close()")
            self._pending.append(req)

    def close(self) -> None:
        with self._lock:
            self._closed = True

    @property
    def has_more(self) -> bool:
        with self._lock:
            return bool(self._pending) or not self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def poll(self, now: float) -> List[Request]:
        with self._lock:
            due = [r for r in self._pending if r.arrival_time <= now]
            self._pending = [r for r in self._pending
                             if r.arrival_time > now]
        return sorted(due, key=lambda r: (r.arrival_time, r.rid))


def _gaps(kind: str, n: int, mean_gap: float,
          rng: np.random.RandomState) -> np.ndarray:
    """Inter-arrival gaps in virtual steps, mean roughly ``mean_gap``."""
    if kind == "static":
        return np.zeros(n)
    if kind in ("poisson", "prefixheavy"):
        return rng.exponential(mean_gap, size=n)
    if kind == "bursty":
        # arrivals cluster: every burst lands together, then the lane
        # goes quiet long enough to keep the same mean rate
        gaps = np.zeros(n)
        i = 0
        while i < n:
            burst = int(rng.randint(2, 5))
            gaps[i] = rng.exponential(mean_gap) * burst
            i += burst
        return gaps
    if kind == "heavytail":
        # Pareto(alpha=1.5): finite mean (= 2 for the standard form),
        # infinite variance -- long lulls punctured by pile-ups
        return rng.pareto(1.5, size=n) * mean_gap / 2.0
    raise ValueError(f"unknown trace kind {kind!r}; "
                     f"expected one of {TRACE_KINDS}")


def make_trace(kind: str, n: int, vocab: int, *, seed: int = 0,
               mean_gap: float = 2.0, tenants: int = 1,
               max_new: int = 8, prompt_cap: int = 24,
               shared_frac: float = 0.0, n_bases: int = 2,
               deadline_slack: Optional[float] = None,
               priority_classes: Optional[Sequence[int]] = None
               ) -> RequestSource:
    """Seeded, replayable arrival trace (see module docstring).

    ``deadline_slack`` (in decode-steps per owed token) sets
    ``deadline = arrival + slack * max_new``; ``priority_classes``
    cycles the given classes across requests.  Same seed, same trace --
    byte-for-byte.
    """
    if kind == "prefixheavy" and shared_frac <= 0.0:
        # nearly every request rides a shared base unless the caller
        # pinned an explicit mix; still seeded and fully replayable
        shared_frac = 0.85
    rng = np.random.RandomState(seed)
    gaps = _gaps(kind, n, mean_gap, rng)
    bases = [rng.randint(2, vocab, size=int(rng.randint(
        max(4, prompt_cap // 2), prompt_cap))) for _ in range(n_bases)]
    reqs: List[Request] = []
    t = 0.0
    for i in range(n):
        t += float(gaps[i])
        if shared_frac > 0.0 and rng.rand() < shared_frac:
            base = bases[int(rng.randint(len(bases)))]
            extra = int(rng.randint(0, 6))
            prompt = (np.concatenate([base, rng.randint(2, vocab,
                                                        size=extra)])
                      if extra else base.copy())
        else:
            prompt = rng.randint(2, vocab,
                                 size=int(rng.randint(4, prompt_cap)))
        reqs.append(Request(
            rid=i, prompt=prompt, max_new=max_new,
            tenant=f"tenant{i % max(1, tenants)}",
            arrival_time=round(t, 6),
            deadline=(None if deadline_slack is None
                      else round(t + deadline_slack * max_new, 6)),
            priority_class=(0 if not priority_classes
                            else int(priority_classes[
                                i % len(priority_classes)]))))
    return RequestSource(reqs)
