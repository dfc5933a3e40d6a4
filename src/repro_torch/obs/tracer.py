"""Span tracer: causal, step-clocked events across the serving stack.

Counterpart of ``repro/obs/tracer.py``.  Every context carries the no-op
``NULL_TRACER``; hot paths test ``tracer.enabled`` before building event
arguments, so with it instrumentation costs one attribute read and the run
is bitwise the untraced one.  ``SpanTracer`` records Trace-Event-Format
events (``B/E`` slices, ``b/e`` async spans keyed by request id, ``i``
instants, ``C`` counters, ``s/f`` flows) stamped by a ``StepClock``: one
scheduler step is one quantum, events within a step take sub-ticks, so a
trace is reproducible for a fixed seed.  ``obs/export.py`` serialises it.
The ``Obs`` bundle and the profiler's measured track wait for ROADMAP
queue 1, item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: sub-ticks per scheduler step; exported ts = step * quantum + seq
STEP_QUANTUM = 1000


class StepClock:
    """Deterministic step-based clock: ``now()`` increases monotonically,
    by sub-ticks within a step and by quanta across steps."""

    def __init__(self):
        self.step = 0
        self._seq = 0

    def set_step(self, step: int) -> None:
        if step > self.step:
            self.step = step
            self._seq = 0

    def now(self) -> float:
        ts = self.step * STEP_QUANTUM + min(self._seq, STEP_QUANTUM - 1)
        self._seq += 1
        return float(ts)


@dataclasses.dataclass
class TraceEvent:
    """One Trace-Event-Format record (see module docstring for phases)."""
    ph: str                       # B E b e i C s f
    name: str
    cat: str
    ts: float
    pid: object                   # process track (pod / "core" / "fleet")
    tid: object                   # thread track ("pe3" / "cq" / "requests")
    id: Optional[int] = None      # async-span / flow correlation id (rid)
    args: Optional[dict] = None


class Tracer:
    """No-op base tracer: ``enabled`` is False and every method does
    nothing, so unguarded calls are safe too."""

    enabled: bool = False

    def __init__(self):
        self.clock = StepClock()

    def begin(self, name, cat, pid, tid, **args) -> None:
        pass

    def end(self, name, cat, pid, tid, **args) -> None:
        pass

    def async_begin(self, name, cat, id, pid, tid, **args) -> None:
        pass

    def async_end(self, name, cat, id, pid, tid, **args) -> None:
        pass

    def instant(self, name, cat, pid, tid, **args) -> None:
        pass

    def counter(self, name, pid, tid, **values) -> None:
        pass

    def flow_start(self, id, name, pid, tid) -> None:
        pass

    def flow_end(self, id, name, pid, tid) -> None:
        pass


#: shared do-nothing tracer
NULL_TRACER = Tracer()


class SpanTracer(Tracer):
    """Recording tracer: bounded in-memory event list + open-span ledger.

    ``max_events`` bounds memory; past it new events are *counted*
    (``dropped``) but not stored — a truncated trace stays valid (it never
    drops an already-recorded begin's end: ends of known-open spans are
    always admitted)."""

    enabled = True

    def __init__(self, max_events: int = 1 << 20):
        super().__init__()
        self.max_events = max_events
        self.events: List[TraceEvent] = []
        self.dropped = 0
        # open-span bookkeeping (validation + always-close-on-truncate)
        self._open_slices: Dict[tuple, List[str]] = {}   # (pid,tid) -> stack
        self._open_async: Dict[tuple, int] = {}          # (cat,id,name) -> n

    # ------------------------------------------------------------ plumbing
    def _emit(self, ev: TraceEvent, *, force: bool = False) -> None:
        if len(self.events) >= self.max_events and not force:
            self.dropped += 1
            return
        self.events.append(ev)

    def now(self) -> float:
        return self.clock.now()

    # ------------------------------------------------------ thread slices
    def begin(self, name, cat, pid, tid, **args) -> None:
        self._open_slices.setdefault((pid, tid), []).append(name)
        self._emit(TraceEvent("B", name, cat, self.now(), pid, tid,
                              args=args or None))

    def end(self, name, cat, pid, tid, **args) -> None:
        stack = self._open_slices.get((pid, tid))
        if stack and stack[-1] == name:
            stack.pop()
        self._emit(TraceEvent("E", name, cat, self.now(), pid, tid,
                              args=args or None), force=True)

    # ------------------------------------------------------- async spans
    def async_begin(self, name, cat, id, pid, tid, **args) -> None:
        key = (cat, id, name)
        self._open_async[key] = self._open_async.get(key, 0) + 1
        self._emit(TraceEvent("b", name, cat, self.now(), pid, tid, id=id,
                              args=args or None))

    def async_end(self, name, cat, id, pid, tid, **args) -> None:
        key = (cat, id, name)
        open_n = self._open_async.get(key, 0)
        if open_n:
            self._open_async[key] = open_n - 1
        self._emit(TraceEvent("e", name, cat, self.now(), pid, tid, id=id,
                              args=args or None), force=open_n > 0)

    # ---------------------------------------------------------- the rest
    def instant(self, name, cat, pid, tid, **args) -> None:
        self._emit(TraceEvent("i", name, cat, self.now(), pid, tid,
                              args=args or None))

    def counter(self, name, pid, tid, **values) -> None:
        self._emit(TraceEvent("C", name, "counter", self.now(), pid, tid,
                              args=values))

    def flow_start(self, id, name, pid, tid) -> None:
        self._emit(TraceEvent("s", name, "flow", self.now(), pid, tid,
                              id=id))

    def flow_end(self, id, name, pid, tid) -> None:
        self._emit(TraceEvent("f", name, "flow", self.now(), pid, tid,
                              id=id))

    # -------------------------------------------------------------- query
    def open_spans(self) -> dict:
        """Spans begun but not ended — must be empty at end of a clean run
        (the causality invariant tests assert this)."""
        slices = {k: list(v) for k, v in self._open_slices.items() if v}
        asyncs = {k: n for k, n in self._open_async.items() if n}
        return {"slices": slices, "async": asyncs}

    def __len__(self) -> int:
        return len(self.events)
