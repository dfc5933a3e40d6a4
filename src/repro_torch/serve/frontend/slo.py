"""SLO-aware admission: deadline classes, priority scheduling, shedding,
and preemptive eviction — on the scheduler's :class:`AdmissionPolicy` hooks.

A copy of ``repro/serve/frontend/slo.py`` (pure Python, on the port's
scheduler hooks): the port keeps its own so that it imports nothing of the
JAX package.

The policy never touches the migration protocol; it only decides *what runs
next*, which is why the disagg bitwise guarantee survives any schedule it
produces (property-tested in ``tests/test_torch_fleet.py``):

- **admit** — backpressure at submit: past ``queue_bound`` best-effort
  traffic is shed outright, and past ``hard_bound`` everything is (the
  queue must stay bounded or TTFD for *every* class collapses — shedding
  the overload is what keeps goodput from cratering past saturation).
- **select** — earliest-deadline-first within the highest waiting priority
  class: an interactive request never queues behind a batch scan.
- **waiting_order** — the same ordering applied to slot waiters (parked
  streams, preempted requests).
- **preempt_victim** — a slot-starved non-best-effort request may evict a
  best-effort request that is *over budget* (generated at least its class's
  ``decode_budget`` tokens) back to the pool; the victim's KV stays in its
  blocks and it resumes on the same decode PE when a slot frees.  A request
  preempted ``max_preemptions`` times becomes immune (no livelock).

Classes are plain frozen data: priority 0 is most urgent; ``ttfd_deadline``
is the arrival->first-decode-token budget in scheduler steps that goodput
accounting (``frontend/metrics.py``) checks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serve.scheduler import AdmissionPolicy, Request


@dataclasses.dataclass(frozen=True)
class SLOClass:
    name: str
    priority: int                    # 0 = most urgent
    ttfd_deadline: int               # arrival -> first token, in sched steps
    e2e_deadline: int = 10_000       # arrival -> finish budget
    best_effort: bool = False        # sheddable + preemptible
    decode_budget: int = 0           # tokens before an over-budget preempt


#: default deadline-class catalog (override per deployment)
CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", 0, ttfd_deadline=8,
                            e2e_deadline=24),
    "standard": SLOClass("standard", 1, ttfd_deadline=16, e2e_deadline=48),
    "batch": SLOClass("batch", 2, ttfd_deadline=64, e2e_deadline=256,
                      best_effort=True, decode_budget=1),
}

DEFAULT_CLASS = "standard"


def resolve(slo, classes: Optional[Dict[str, SLOClass]] = None) -> SLOClass:
    """Map a request's opaque ``slo`` tag (name, class, or None) to a
    class.  Unknown names fall back to the default class rather than
    erroring — a frontend must not die on a mislabeled request."""
    classes = CLASSES if classes is None else classes
    if isinstance(slo, SLOClass):
        return slo
    return classes.get(slo, classes[DEFAULT_CLASS])


class SLOPolicy(AdmissionPolicy):
    """Deadline-class admission over the DisaggScheduler hooks."""

    def __init__(self, *, queue_bound: int = 16,
                 hard_bound: Optional[int] = None,
                 classes: Optional[Dict[str, SLOClass]] = None,
                 max_preemptions: int = 2):
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        self.queue_bound = queue_bound
        self.hard_bound = (2 * queue_bound if hard_bound is None
                           else hard_bound)
        self.classes = CLASSES if classes is None else classes
        self.max_preemptions = max_preemptions

    # ------------------------------------------------------------- helpers
    def cls(self, req: Request) -> SLOClass:
        return resolve(req.slo, self.classes)

    def _deadline(self, req: Request) -> int:
        return req.arrival_step + self.cls(req).ttfd_deadline

    def _rank(self, req: Request) -> tuple:
        """Priority first, earliest TTFD deadline second, FIFO third."""
        return (self.cls(req).priority, self._deadline(req),
                req.arrival_step, req.rid)

    # --------------------------------------------------------------- hooks
    def admit(self, req: Request, queue_len: int) -> bool:
        c = self.cls(req)
        if queue_len >= self.hard_bound:
            return False
        if queue_len >= self.queue_bound and c.best_effort:
            return False
        return True

    def select(self, queue) -> int:
        return min(range(len(queue)), key=lambda i: self._rank(queue[i]))

    def waiting_order(self, reqs: List[Request]) -> List[Request]:
        return sorted(reqs, key=self._rank)

    def preempt_victim(self, req: Request,
                       decoding: List[Request]) -> Optional[Request]:
        c = self.cls(req)
        if c.best_effort:
            return None                  # best effort never preempts anyone
        cands = [r for r in decoding
                 if self.cls(r).best_effort
                 and self.cls(r).priority > c.priority
                 and len(r.out) >= max(1, self.cls(r).decode_budget)
                 and r.preemptions < self.max_preemptions]
        if not cands:
            return None
        # most decode progress first: it has consumed the most budget and
        # loses the least (its KV is banked in the pool either way)
        return max(cands, key=lambda r: (len(r.out), -r.rid))
