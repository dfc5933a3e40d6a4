"""Spans around the parts of one model step.

A step of a latent-attention model (``models/model.py``) marks two parts
of every layer: its attention (``<step>.mla``) and its mixture of experts
(``<step>.moe``: router, dispatch, routed and shared experts, combine),
with ``<step>`` ``decode`` or ``prefill``.  Each part records as a span on
a wall-clocked tracer (``tracer.timed``, inside the engine's
``decode.model`` or the scheduler's ``prefill``) and, while a
``torch.profiler`` records, as a ``record_function`` range of the same
name, whose device-side span the profiler keeps.  The MoE also records a
``moe`` counter a call on the timed tracer: tokens routed, the most any
one expert received, the experts touched, and the assignments dropped.
The marks are ambient, as the policy is: a caller makes a step's marks
current with :func:`use`, and the model calls :func:`part` and
:func:`routing`, which do nothing while none are.  Where neither records,
:meth:`LayerSpans.make` returns None and nothing is marked.
"""
from __future__ import annotations

import contextlib

import torch

_CURRENT = None             # the marks of the step running now
_NO_PART = contextlib.nullcontext()


def current():
    return _CURRENT


@contextlib.contextmanager
def use(marks):
    """Make ``marks`` current in the block: a :class:`LayerSpans`, None,
    or a stand-in with its ``part``, ``counting`` and ``routing``
    (``models/decode_graph.py`` captures through one)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, marks
    try:
        yield marks
    finally:
        _CURRENT = prev


def part(name: str):
    marks = _CURRENT
    return _NO_PART if marks is None else marks.part(name)


def routing(**route) -> None:
    """A MoE call's routing (``models/moe.py::moe_ffn_dropless``)."""
    marks = _CURRENT
    if marks is not None and marks.counting:
        marks.routing(**route)


class LayerSpans:
    """The spans of one step (``"decode"`` or ``"prefill"``) on ``track``,
    a ``(pid, tid)`` of the tracer."""

    def __init__(self, step: str, tracer, track, ranges: bool):
        self.step = step
        self.tracer = tracer
        self.pid, self.tid = track
        self.ranges = ranges

    @classmethod
    def make(cls, step: str, tracer, track):
        """The spans of a step, or None where nothing would record them:
        ``tracer`` (None or any tracer) is not wall-clocked and no profiler
        is recording."""
        timed = tracer if tracer is not None and tracer.enabled \
            and tracer.timed else None
        ranges = torch.autograd._profiler_enabled()
        if timed is None and not ranges:
            return None
        return cls(step, timed, track, ranges)

    @contextlib.contextmanager
    def part(self, name: str):
        full = f"{self.step}.{name}"
        if self.tracer is not None:
            self.tracer.begin(full, "model", self.pid, self.tid)
        try:
            if self.ranges:
                with torch.profiler.record_function(full):
                    yield
            else:
                yield
        finally:
            if self.tracer is not None:
                self.tracer.end(full, "model", self.pid, self.tid)

    @property
    def counting(self) -> bool:
        return self.tracer is not None

    def counter(self, name: str, **values) -> None:
        if self.tracer is not None:
            self.tracer.counter(name, self.pid, self.tid, **values)

    def routing(self, **route) -> None:
        """A MoE call's routing as its ``moe`` counter."""
        from repro_torch.models.moe import routing_counts
        self.counter("moe", **routing_counts(**route))
