"""Always-on flight recorder: a bounded ring of recent spans + metrics rows
that turns into a *valid* postmortem trace the moment something goes wrong.

Counterpart of ``repro/obs/recorder.py``.

Production runs keep full tracing off (the bitwise-identical-off contract);
this module is the middle setting: a :class:`RingTracer` records into a
last-K-steps ring (old events fall off the back, memory stays bounded, no
export unless asked), and a :class:`FlightRecorder` snapshots that window
into a Chrome-trace document on demand — on an unhandled exception in the
fleet loop, on an :class:`~repro_torch.obs.audit.AuditError`, or on an SLO
burn-rate alert (``repro_torch.obs.alerts``).

A raw window slice is *not* a valid trace: spans that began before the
window opened have dangling ``E``/``e`` closers, flows can lose one end,
and spans still open at the crash have no close at all.  ``snapshot``
repairs all three — unmatched closers and half-flows are dropped, still-
open spans get synthesized closes (``args: {"truncated": true}``) at the
window tail — so every dump passes ``export.validate`` clean and loads in
Perfetto.  Postmortem context (reason, step, eviction count, the recent
metrics rows) rides in ``otherData.postmortem``, deliberately *not* in
``otherData.dropped_events``: window eviction is the recorder working as
designed, not tracer truncation.

When full tracing is already on, point the recorder at the main
:class:`SpanTracer` instead — dumps become windowed slices of the complete
trace, with the same repair.
"""
from __future__ import annotations

import collections
import json
from typing import Deque, List, Optional

from repro_torch.obs.export import chrome_trace_events
from repro_torch.obs.tracer import SpanTracer, TraceEvent, event_step

__all__ = ["RingTracer", "FlightRecorder"]


class RingTracer(SpanTracer):
    """A :class:`SpanTracer` whose buffer is a last-``window_steps`` ring.

    Events older than the window (by the step each was recorded in) are
    evicted from the front as new ones arrive; ``evicted`` counts them.  A hard
    ``max_events`` cap additionally bounds pathological single-step floods.
    Nothing is ever "dropped" in the truncation sense — the ring is the
    design, and :class:`FlightRecorder` repairs the window edge at dump
    time."""

    def __init__(self, window_steps: int = 64, max_events: int = 1 << 20,
                 clock=None):
        super().__init__(max_events=max_events, clock=clock)
        self.window_steps = window_steps
        self.events: Deque[TraceEvent] = collections.deque()
        self.evicted = 0

    def _emit(self, ev: TraceEvent, *, force: bool = False) -> None:
        if self.timed:
            ev.step = self.clock.step
        self.events.append(ev)
        floor = self.clock.step - self.window_steps
        while self.events and event_step(self.events[0]) < floor:
            self.events.popleft()
            self.evicted += 1
        while len(self.events) > self.max_events:
            self.events.popleft()
            self.evicted += 1


class FlightRecorder:
    """Windowed postmortem dumps over a live tracer (ring or full).

    ``note_metrics(row)`` keeps the last-window metrics rows alongside the
    spans; ``dump(reason=...)`` writes the repaired window as a Chrome-trace
    JSON document and remembers the path in ``dumps``.
    """

    def __init__(self, tracer: SpanTracer, *, window_steps: int = 64,
                 path: str = "postmortem_trace.json"):
        self.tracer = tracer
        self.window_steps = window_steps
        self.path = path
        self.dumps: List[str] = []
        self._metrics: Deque[dict] = collections.deque()

    # ------------------------------------------------------------- intake
    def note_metrics(self, row: dict) -> None:
        """Remember a metrics sample row (must carry ``"step"``)."""
        self._metrics.append(row)
        floor = self.tracer.clock.step - self.window_steps
        while self._metrics and self._metrics[0].get("step", 0) < floor:
            self._metrics.popleft()

    # -------------------------------------------------------- window + fix
    def _window(self, step: int) -> List[TraceEvent]:
        floor = step - self.window_steps
        return [ev for ev in self.tracer.events if event_step(ev) >= floor]

    @staticmethod
    def _repair(events: List[TraceEvent]) -> List[TraceEvent]:
        """Make a window slice structurally valid (see module docstring):
        drop closers whose opens fell off the window edge, drop flow events
        whose pair is missing (keeping matched pairs), then synthesize
        closes for spans still open at the tail."""
        n_s = collections.Counter(ev.id for ev in events if ev.ph == "s")
        n_f = collections.Counter(ev.id for ev in events if ev.ph == "f")
        flow_keep = {fid: min(n, n_f.get(fid, 0)) for fid, n in n_s.items()}
        seen_s: collections.Counter = collections.Counter()
        seen_f: collections.Counter = collections.Counter()

        kept: List[TraceEvent] = []
        stacks: dict = {}          # (pid, tid) -> [(name, cat)]
        async_open: dict = {}      # (cat, id, name) -> [count, pid, tid]
        for ev in events:
            if ev.ph == "B":
                stacks.setdefault((ev.pid, ev.tid), []).append((ev.name,
                                                                ev.cat))
                kept.append(ev)
            elif ev.ph == "E":
                stack = stacks.get((ev.pid, ev.tid))
                if stack and stack[-1][0] == ev.name:
                    stack.pop()
                    kept.append(ev)
                # else: open fell off the window — drop the dangling closer
            elif ev.ph == "b":
                rec = async_open.setdefault((ev.cat, ev.id, ev.name),
                                            [0, ev.pid, ev.tid])
                rec[0] += 1
                kept.append(ev)
            elif ev.ph == "e":
                rec = async_open.get((ev.cat, ev.id, ev.name))
                if rec is not None and rec[0] > 0:
                    rec[0] -= 1
                    kept.append(ev)
            elif ev.ph == "s":
                seen_s[ev.id] += 1
                if seen_s[ev.id] <= flow_keep.get(ev.id, 0):
                    kept.append(ev)
            elif ev.ph == "f":
                seen_f[ev.id] += 1
                if seen_f[ev.id] <= flow_keep.get(ev.id, 0):
                    kept.append(ev)
            else:                   # i / C / anything future
                kept.append(ev)

        # synthesized closes at the tail, strictly increasing timestamps so
        # every track stays monotonic
        ts = (max(ev.ts for ev in kept) if kept else 0.0) + 1.0
        for (pid, tid), stack in sorted(stacks.items(),
                                        key=lambda kv: str(kv[0])):
            for name, cat in reversed(stack):
                kept.append(TraceEvent("E", name, cat, ts, pid, tid,
                                       args={"truncated": True}))
                ts += 1.0
        for (cat, aid, name), (n, pid, tid) in sorted(
                async_open.items(), key=lambda kv: str(kv[0])):
            for _ in range(n):
                kept.append(TraceEvent("e", name, cat, ts, pid, tid, id=aid,
                                       args={"truncated": True}))
                ts += 1.0
        return kept

    # -------------------------------------------------------------- output
    def snapshot(self, *, reason: str, step: Optional[int] = None) -> dict:
        """The repaired window as a Chrome-trace document (no file I/O)."""
        step = self.tracer.clock.step if step is None else step
        events = self._repair(self._window(step))
        evicted = getattr(self.tracer, "evicted", 0)
        return chrome_trace_events(
            events, dropped=getattr(self.tracer, "dropped", 0),
            clock="wall" if self.tracer.timed else "step",
            other={"postmortem": {
                "reason": reason,
                "step": step,
                "window_steps": self.window_steps,
                "evicted": evicted,
                "metrics_rows": list(self._metrics),
            }})

    def dump(self, path: Optional[str] = None, *, reason: str,
             step: Optional[int] = None) -> str:
        """Write a postmortem dump; returns the path written."""
        path = self.path if path is None else path
        doc = self.snapshot(reason=reason, step=step)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        self.dumps.append(path)
        return path

    def summary(self) -> dict:
        return {"window_steps": self.window_steps,
                "buffered_events": len(self.tracer.events),
                "evicted": getattr(self.tracer, "evicted", 0),
                "dumps": list(self.dumps)}
