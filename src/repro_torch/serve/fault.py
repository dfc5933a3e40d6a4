"""Deterministic fault injection for the serving fleet (DESIGN.md §14).

Counterpart of ``repro/serve/fault.py``: the plan grammar, the seeded
random plans (the same ``PCG64`` draws, so plans match the reference's),
the injector and the ``ISHMEM_FAULT_*`` knobs are pure Python; only
:func:`scramble_rows` touches the heap, poisoning a dead PE's rows on the
heap's device.

Failures in the simulated cluster are *scheduled*, not sampled from wall
time: a :class:`FaultPlan` is a list of :class:`FaultEvent`\\ s pinned to
fleet steps, so a chaos run is exactly reproducible — the same plan against
the same traffic produces the same faults at the same points in the same
schedule, which is what lets the chaos harness assert bitwise-identical
surviving outputs against a no-fault control run.

Event kinds (``kind=arg@step`` in the spec grammar):

- ``kill_pe=4@6``    — PE 4 dies at step 6: its heap row becomes garbage,
  in-flight ops touching it cancel with error, and the owning pod's
  scheduler runs KV-block recovery (``serve/recovery.py``).
- ``kill_pod=pod1@6``— every PE of pod1 dies at once; the pod's live
  requests are adopted by surviving pods (full replay).
- ``partition=3@8``  — the inter-pod (dcn) fabric partitions at step 8 for
  3 steps: cross-pod traffic is neither delivered nor lost, it stays on
  the completion queue until the partition heals.
- ``drain=pod0@4``   — pod0 is administratively drained: the router stops
  placing new arrivals there, queued-but-unstarted requests re-route.
- ``join=pod0@9``    — a drained pod rejoins the router rotation.

Seeded *random* plans (:meth:`FaultPlan.random`) drive the property-test
sweep; the generator uses a counter-based PRNG keyed only by the seed, so
no wall clock or global RNG state leaks into the plan.

``ISHMEM_FAULT_PLAN`` / ``ISHMEM_FAULT_SEED`` expose the same knobs to the
launcher (``repro_torch.launch.serve --chaos``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, Optional, Sequence

import torch

PREFIX = "ISHMEM_FAULT_"

#: recognized fault kinds, in spec-grammar order
KINDS = ("kill_pe", "kill_pod", "partition", "drain", "join")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: what happens, to whom, at which fleet step."""
    step: int
    kind: str                   # one of KINDS
    arg: str                    # pe id, pod name, or partition duration

    def spec(self) -> str:
        return f"{self.kind}={self.arg}@{self.step}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule (ordered by step, then spec text)."""
    events: tuple = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        """Parse the comma-separated ``kind=arg@step`` grammar."""
        events: List[FaultEvent] = []
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            try:
                head, step_s = token.rsplit("@", 1)
                kind, arg = head.split("=", 1)
                step = int(step_s)
            except ValueError:
                raise ValueError(
                    f"fault spec token {token!r}: expected kind=arg@step "
                    f"(e.g. kill_pe=4@6)") from None
            kind = kind.strip().lower()
            if kind not in KINDS:
                raise ValueError(
                    f"fault spec token {token!r}: unknown kind {kind!r} "
                    f"(one of {KINDS})")
            if step < 0:
                raise ValueError(
                    f"fault spec token {token!r}: step must be >= 0")
            arg = arg.strip()
            if kind in ("kill_pe", "partition"):
                try:
                    if int(arg) < 0:
                        raise ValueError
                except ValueError:
                    raise ValueError(
                        f"fault spec token {token!r}: {kind} takes a "
                        f"non-negative integer, got {arg!r}") from None
            events.append(FaultEvent(step=step, kind=kind, arg=arg))
        events.sort(key=lambda e: (e.step, e.spec()))
        return cls(events=tuple(events), seed=seed)

    @classmethod
    def random(cls, seed: int, *, max_step: int,
               pes: Sequence[int] = (), pods: Sequence[str] = (),
               n_events: int = 1,
               partition_steps: int = 3) -> "FaultPlan":
        """Seeded random plan over the given victim sets — the chaos
        harness's sweep generator.  Counter-based PRNG (PCG64 keyed by the
        seed alone), so the plan is a pure function of its arguments."""
        import numpy as np
        rng = np.random.default_rng(np.random.PCG64((int(seed), 0xFA17)))
        kinds = []
        if pes:
            kinds.append("kill_pe")
        if pods:
            kinds += ["kill_pod", "partition"]
        if not kinds:
            raise ValueError("random plan needs pes and/or pods to target")
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max(2, max_step)))
            if kind == "kill_pe":
                arg = str(pes[int(rng.integers(len(pes)))])
            elif kind == "kill_pod":
                arg = str(pods[int(rng.integers(len(pods)))])
            else:
                arg = str(partition_steps)
            events.append(FaultEvent(step=step, kind=kind, arg=arg))
        events.sort(key=lambda e: (e.step, e.spec()))
        return cls(events=tuple(events), seed=int(seed))

    def spec(self) -> str:
        """Round-trip back to the ``ISHMEM_FAULT_PLAN`` grammar."""
        return ",".join(e.spec() for e in self.events)


class FaultInjector:
    """Applies a :class:`FaultPlan` against a live Fleet, one step at a
    time.  The fleet calls :meth:`apply` at the top of every ``step()``
    (before arrivals submit), so a fault at step N happens-before step N's
    traffic — deterministically.  Partition healing is tracked here: a
    ``partition=K@N`` event downs the dcn fabric at N and heals it at
    N + K."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_step = {}
        for ev in plan.events:
            self._by_step.setdefault(ev.step, []).append(ev)
        self.heal_step: Optional[int] = None
        self.fired: List[dict] = []

    def apply(self, fleet, step: int) -> None:
        if self.heal_step is not None and step >= self.heal_step:
            fleet.heal()
            self.fired.append({"step": step, "kind": "heal", "arg": ""})
            self.heal_step = None
        for ev in self._by_step.get(step, ()):
            if ev.kind == "kill_pe":
                fleet.kill_pe(int(ev.arg))
            elif ev.kind == "kill_pod":
                fleet.kill_pod(ev.arg)
            elif ev.kind == "partition":
                fleet.partition()
                self.heal_step = step + int(ev.arg)
            elif ev.kind == "drain":
                fleet.drain(ev.arg)
            elif ev.kind == "join":
                fleet.join(ev.arg)
            self.fired.append({"step": step, "kind": ev.kind,
                               "arg": ev.arg})


# ---------------------------------------------------------------------------
# dead-row scrambling
# ---------------------------------------------------------------------------


def scramble_rows(heap, pes):
    """Overwrite the heap rows of dead PEs with poison: NaN in float pools,
    ``iinfo.max`` in unsigned and ``iinfo.min + 1`` in signed integer pools
    (bit for bit the reference's).  A dead PE's memory is gone; anything
    that still reads it after recovery carries the poison into decoded
    tokens, which the chaos harness's bitwise check then catches.  The
    rows are filled in place on the pool's own device, so every snapshot
    sharing the pool loses them too (and a multi-gigabyte pool is not
    copied).  Returns the heap."""
    rows = [int(pe) for pe in pes]
    for pool in heap.pools.values():
        if pool.dtype.is_floating_point:
            poison = float("nan")
        elif pool.dtype in (torch.uint8, torch.uint16, torch.uint32,
                            torch.uint64):
            poison = torch.iinfo(pool.dtype).max
        else:
            poison = torch.iinfo(pool.dtype).min + 1
        pool[rows] = poison
    return heap


# ---------------------------------------------------------------------------
# ISHMEM_FAULT_* environment knobs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEnvCfg:
    plan: str = ""              # kind=arg@step[,kind=arg@step...]
    seed: int = 0


def load_fault_env(environ: Optional[Mapping[str, str]] = None) -> FaultEnvCfg:
    """Parse ``ISHMEM_FAULT_PLAN`` / ``ISHMEM_FAULT_SEED`` (defaults on an
    empty env).  The plan string is validated here — a bad grammar fails
    at launch, not mid-chaos-run."""
    env = os.environ if environ is None else environ

    def get(name: str) -> Optional[str]:
        val = env.get(PREFIX + name)
        return val if val not in (None, "") else None

    seed_raw = get("SEED")
    if seed_raw is None:
        seed = 0
    else:
        try:
            seed = int(seed_raw)
        except ValueError:
            raise ValueError(f"{PREFIX}SEED: expected an integer, "
                             f"got {seed_raw!r}") from None
        if seed < 0:
            raise ValueError(f"{PREFIX}SEED: must be >= 0, got {seed}")
    plan = get("PLAN") or ""
    if plan:
        FaultPlan.parse(plan, seed=seed)        # validate the grammar now
    return FaultEnvCfg(plan=plan, seed=seed)
