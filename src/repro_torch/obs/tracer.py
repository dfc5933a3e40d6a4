"""Span tracer: causal, step-clocked events across the serving stack.

Counterpart of ``repro/obs/tracer.py``.  Every context carries the no-op
``NULL_TRACER``; hot paths wrap a region in ``tracer.span`` and test
``tracer.enabled`` before building event arguments that cost work, so with
it instrumentation costs an attribute read or two and the run is bitwise
the untraced one.  ``SpanTracer`` records Trace-Event-Format
events (``B/E`` slices, ``b/e`` async spans keyed by request id, ``i``
instants, ``C`` counters, ``s/f`` flows) stamped by a ``StepClock``: one
scheduler step is one quantum, events within a step take sub-ticks, so a
trace is reproducible for a fixed seed.  A tracer built on a ``WallClock``
stamps integer microseconds on the clock ``torch.profiler`` stamps its
events with instead, keeps each event's scheduler step beside it, and is
``timed``: only then do the serving path's spans inside a step (the decode
step's parts, staging) record, as a step-clocked span there has no
duration: such a site traces on ``tracer if tracer.timed else
NULL_TRACER``.  ``obs/export.py`` serialises it; the ``Obs`` bundle
(``obs/__init__.py``) installs a tracer on a run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

#: sub-ticks per scheduler step; exported ts = step * quantum + seq
STEP_QUANTUM = 1000


class StepClock:
    """Deterministic step-based clock: ``now()`` increases monotonically,
    by sub-ticks within a step and by quanta across steps."""

    timed = False

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


class WallClock:
    """Integer microseconds since the Unix epoch, on the clock the torch
    profiler stamps host and device events with (``time.time_ns``).  One
    ``time_ns``/``perf_counter_ns`` pair taken at construction anchors
    it, so it never runs backwards when the system clock is stepped.
    ``set_step`` only records the scheduler step, which every event
    stamped on this clock carries."""

    timed = True

    def __init__(self):
        self.step = 0
        self._unix_ns = time.time_ns()
        self._perf_ns = time.perf_counter_ns()

    def set_step(self, step: int) -> None:
        self.step = max(self.step, step)

    def now(self) -> int:
        return self.at_ns(time.perf_counter_ns())

    def at_ns(self, perf_counter_ns: int) -> int:
        """The clock's reading at a ``time.perf_counter_ns()`` value."""
        return (self._unix_ns + perf_counter_ns - self._perf_ns) // 1000


def event_step(ev) -> int:
    """The scheduler step an event was recorded in, on either clock."""
    return ev.step if ev.step is not None else int(ev.ts) // STEP_QUANTUM


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
    step: Optional[int] = None    # scheduler step, under a WallClock only


class Tracer:
    """No-op base tracer: ``enabled`` is False and every method does
    nothing, so unguarded calls are safe too."""

    enabled: bool = False
    timed: bool = False           # stamped on a WallClock

    def __init__(self, clock=None):
        self.clock = StepClock() if clock is None else clock
        self.timed = self.clock.timed

    def begin(self, name, cat, pid, tid, **args) -> None:
        pass

    def end(self, name, cat, pid, tid, **args) -> None:
        pass

    def span(self, name, cat, pid, tid, **args):
        return _NO_SPAN

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


_NO_SPAN = contextlib.nullcontext()

#: shared do-nothing tracer
NULL_TRACER = Tracer()


class SpanTracer(Tracer):
    """Recording tracer: bounded in-memory event list + open-span ledger.

    ``max_events`` bounds memory; past it new events are *counted*
    (``dropped``) but not stored — a truncated trace stays valid (it never
    drops an already-recorded begin's end: ends of known-open spans are
    always admitted)."""

    enabled = True

    def __init__(self, max_events: int = 1 << 20, clock=None):
        super().__init__(clock)
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
        if self.timed:
            ev.step = self.clock.step
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

    @contextlib.contextmanager
    def span(self, name, cat, pid, tid, **args):
        """``begin`` and ``end`` around a block; a block that raises leaves
        its span open, as a bare ``begin`` would."""
        self.begin(name, cat, pid, tid, **args)
        yield
        self.end(name, cat, pid, tid)

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
