"""The no-op span tracer every context carries.

Counterpart of the ``Tracer`` base and ``NULL_TRACER`` of
``repro/obs/tracer.py``.  Hot paths test ``tracer.enabled`` before building
event arguments, so with this tracer instrumentation costs one attribute
read.  The recording ``SpanTracer`` and its exporters come later (ROADMAP
queue 1, item 5d).
"""
from __future__ import annotations

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
