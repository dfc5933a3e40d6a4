"""Multi-pod request router: load balancing + shared-prefix affinity.

A copy of ``repro/serve/frontend/router.py`` (numpy only): the port keeps
its own so that it imports nothing of the JAX package.  The same ``PCG64``
draws, so its picks match the reference's.

A *pod* is one (prefill fleet, decode fleet) pair — a contiguous PE slice
of the world, one shared-fabric node (so intra-pod migration is ici tier
and anything between pods is dcn, riding the host-proxy ring).  All pods
share ONE symmetric KV pool and ONE prefix index, so a block id names the
same physical page everywhere and a request routed to the "wrong" pod can
still map a prefix staged elsewhere — it just pays for pulling those
blocks across the pod boundary.

Routing policies (``Router(policy=...)``):

- ``random``       — seeded uniform choice (the control arm for the
  affinity CI gate: its cross-pod wire bytes are the baseline);
- ``round_robin``  — cycles pods regardless of load;
- ``least_loaded`` — minimizes live occupancy: waiting requests plus
  active decode slots over the pod's slot capacity, read live from the
  schedulers' slot banks (``KVPool.stats()`` rides along in
  :meth:`Pod.load` for shed/telemetry views);
- ``affinity``     — if the request declares a shared prefix that is
  already registered, route to the pod whose prefill PE staged it (the
  entry's ``home_pe``): every prefix block is then intra-pod (or already
  resident at the decode PE and skipped entirely), so the dcn wire bytes
  the random arm pays simply vanish.  Misses fall back to least-loaded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.frontend.traffic import RequestSpec


@dataclasses.dataclass
class Pod:
    """One pod's control plane: teams + its DisaggScheduler."""
    name: str
    team: object                      # teams.Team covering the pod's PEs
    prefill: object                   # prefill sub-team
    decode: object                    # decode sub-team
    sched: object                     # DisaggScheduler

    def slot_capacity(self) -> int:
        return sum(len(v) for v in self.sched.slot_req.values())

    def free_slots(self) -> int:
        return sum(1 for v in self.sched.slot_req.values()
                   for owner in v if owner is None)

    def waiting(self) -> int:
        s = self.sched
        return (len(s.queue) + len(s.staged) + len(s.streaming)
                + len(s.parked) + len(s.preempted) + len(s.migrating))

    def occupancy(self) -> float:
        """Live load score: waiting requests + busy slots, normalized by
        slot capacity — the quantity least-loaded routing minimizes."""
        cap = max(1, self.slot_capacity())
        busy = cap - self.free_slots()
        return (self.waiting() + busy) / cap

    def load(self) -> dict:
        """Occupancy + pool view (the pool is fleet-shared, but surfacing
        it here keeps one stop for 'can this pod take more work')."""
        return {
            "waiting": self.waiting(),
            "free_slots": self.free_slots(),
            "slot_capacity": self.slot_capacity(),
            "occupancy": self.occupancy(),
            "pool": self.sched.pool.stats(),
        }


POLICIES = ("random", "round_robin", "least_loaded", "affinity")


class Router:
    """Maps arrivals onto pods; shares the fleet's prefix index read-only."""

    def __init__(self, pods: List[Pod], *, policy: str = "affinity",
                 prefix_index: Optional[Dict] = None, seed: int = 0):
        if not pods:
            raise ValueError("need at least one pod")
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"one of {POLICIES}")
        self.pods = list(pods)
        self.policy = policy
        self.prefix_index = {} if prefix_index is None else prefix_index
        self._rng = np.random.default_rng(np.random.PCG64((seed, 0xF1EE7)))
        self._rr = 0
        self._pe_pod: Dict[int, Pod] = {}
        for pod in self.pods:
            for pe in pod.team.pes():
                self._pe_pod[pe] = pod
        self.stats = {"routed": 0, "affinity_hits": 0}

    # ------------------------------------------------------- drain / join
    def remove_pod(self, pod: Pod) -> None:
        """Stop routing to a pod (drain, or a dead pod leaving the fleet).
        Its PE -> pod affinity keys are dropped too, so a prefix homed
        there falls back to least-loaded instead of a drained target."""
        if pod not in self.pods:
            raise ValueError(f"pod {pod.name} is not routable")
        if len(self.pods) == 1:
            raise ValueError("cannot remove the last routable pod")
        self.pods.remove(pod)
        for pe in pod.team.pes():
            self._pe_pod.pop(pe, None)

    def add_pod(self, pod: Pod) -> None:
        """Re-admit a drained pod (rebuilds its affinity keys)."""
        if pod in self.pods:
            raise ValueError(f"pod {pod.name} is already routable")
        self.pods.append(pod)
        for pe in pod.team.pes():
            self._pe_pod[pe] = pod

    # ------------------------------------------------------------- scoring
    def _least_loaded(self) -> Pod:
        self._rr += 1
        n = len(self.pods)
        return min((self.pods[(self._rr + k) % n] for k in range(n)),
                   key=lambda p: p.occupancy())

    def _home_pod(self, spec: RequestSpec) -> Optional[Pod]:
        key = spec.prefix_key()
        if key is None:
            return None
        entry = self.prefix_index.get(key)
        if entry is None:
            return None
        return self._pe_pod.get(entry.home_pe)

    # --------------------------------------------------------------- route
    def route(self, spec: RequestSpec) -> Pod:
        self.stats["routed"] += 1
        if self.policy == "random":
            return self.pods[int(self._rng.integers(len(self.pods)))]
        if self.policy == "round_robin":
            pod = self.pods[self._rr % len(self.pods)]
            self._rr += 1
            return pod
        if self.policy == "affinity":
            pod = self._home_pod(spec)
            if pod is not None:
                self.stats["affinity_hits"] += 1
                return pod
        return self._least_loaded()
