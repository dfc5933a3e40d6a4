"""Reading the port's own spans and counters beside a profiled ``Slice``.

A run that attaches ``repro_torch.obs.tracer.SpanTracer(clock=WallClock())``
to the scheduler's context records the program's spans (``B``/``E``
slices, the requests' ``b``/``e`` lifelines) and its ``heap`` counter in
integer microseconds on the clock the torch profiler stamps its events
with; the profiler's ``FunctionEvent.time_range`` is that clock less the
trace's start (``kineto_results.trace_start_ns()``).  So a span rebased by
that start lies on the ``Slice``'s axis, and its idle device time is its
interval less the slice's busy union, with no correlation ids.

The readers take the observation's ``program_trace``:
``{"events": [TraceEvent...], "trace_start_ns": int, "window_us": (open,
close)}`` (the window on the program's clock), and the ``slice``; each
returns None where what it reads is absent, as on a program without the
spans.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from perfbench import stats


@dataclasses.dataclass
class Span:
    name: str
    track: tuple        # (pid, tid); the lifeline's for a request phase
    id: object          # request id of a lifeline phase, else None
    start: int          # program clock, us
    end: int
    args: dict

    @property
    def us(self) -> int:
        return self.end - self.start


def spans(events) -> list:
    """Every closed span: ``B``/``E`` slices paired on their track's
    stack, ``b``/``e`` phases paired by (cat, id, name).  ``args`` merges
    the begin's and the end's (the end's win)."""
    out, stacks, lives = [], defaultdict(list), {}
    for ev in events:
        if ev.ph == "B":
            stacks[(ev.pid, ev.tid)].append(ev)
        elif ev.ph == "E":
            stack = stacks[(ev.pid, ev.tid)]
            if stack and stack[-1].name == ev.name:
                b = stack.pop()
                out.append(Span(ev.name, (ev.pid, ev.tid), None, b.ts,
                                ev.ts, {**(b.args or {}), **(ev.args or {})}))
        elif ev.ph == "b":
            lives[(ev.cat, ev.id, ev.name)] = ev
        elif ev.ph == "e":
            b = lives.pop((ev.cat, ev.id, ev.name), None)
            if b is not None:
                out.append(Span(ev.name, (b.pid, b.tid), ev.id, b.ts, ev.ts,
                                {**(b.args or {}), **(ev.args or {})}))
    return sorted(out, key=lambda s: (s.start, -s.end))


def to_slice_us(t_us: float, trace_start_ns: int) -> float:
    """A program-clock time on the ``Slice``'s axis (us from its start)."""
    return t_us - trace_start_ns / 1000.0


def busy_us(sl, a: float, b: float) -> float:
    """Device-busy microseconds of the slice inside [a, b]."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in sl._union)


def idle_us(sl, a: float, b: float) -> float:
    """Microseconds of [a, b] in which no device operation ran."""
    return (b - a) - busy_us(sl, a, b)


def counter_delta(events, name: str, key: str, t0: float, t1: float):
    """Growth of cumulative counter ``name``'s ``key`` over [t0, t1]: its
    last sample at or before t1 less its last before t0 (the first inside
    the window where none came before).  None with fewer than two."""
    samples = [(ev.ts, ev.args[key]) for ev in events
               if ev.ph == "C" and ev.name == name and ev.ts <= t1]
    if not samples:
        return None
    before = [v for t, v in samples if t < t0]
    inside = [v for t, v in samples if t >= t0]
    if not inside or (not before and len(inside) < 2):
        return None
    return inside[-1] - (before[-1] if before else inside[0])


def _trace(obs):
    pt = obs.get("program_trace")
    return pt if pt and pt.get("events") else None


def _in_slice(obs, name: str) -> list:
    """``name``'s spans that lie wholly inside the slice, as (start, end)
    on its axis."""
    pt, sl = _trace(obs), obs.get("slice")
    if pt is None or sl is None:
        return []
    t0 = pt["trace_start_ns"]
    out = []
    for sp in spans(pt["events"]):
        if sp.name == name:
            a, b = to_slice_us(sp.start, t0), to_slice_us(sp.end, t0)
            if 0.0 <= a and b <= sl.wall_s * 1e6:
                out.append((a, b))
    return out


def window_requests(obs) -> set:
    """Request ids whose ``queued`` phase began inside the window: the
    requests submitted, so due, in it."""
    pt = _trace(obs)
    if pt is None:
        return set()
    lo, hi = pt["window_us"]
    return {sp.id for sp in spans(pt["events"])
            if sp.name == "queued" and sp.id is not None
            and lo <= sp.start <= hi}


def _median_ms(values):
    return stats.percentile(values, 50) / 1e3 if values else None


def decode_model_idle_ms(obs):
    """Median over the slice's decode PE-steps of the idle device ms
    inside ``decode.model``."""
    sl = obs.get("slice")
    return _median_ms([idle_us(sl, a, b)
                       for a, b in _in_slice(obs, "decode.model")])


def heap_write_amp(obs):
    """Bytes the heap moved over the bytes it stored in the window:
    (pool bytes cloned + bytes stored) / bytes stored."""
    pt = _trace(obs)
    if pt is None:
        return None
    lo, hi = pt["window_us"]
    copy = counter_delta(pt["events"], "heap", "copy_bytes", lo, hi)
    store = counter_delta(pt["events"], "heap", "store_bytes", lo, hi)
    if copy is None or not store:
        return None
    return (copy + store) / store


def _phase_ms(obs, name: str, by_arg: bool = False):
    """Median duration of ``name``'s spans of the window's requests (the
    request named by the span's ``rid`` argument where ``by_arg``)."""
    pt = _trace(obs)
    if pt is None:
        return None
    rids = window_requests(obs)
    return _median_ms([
        sp.us for sp in spans(pt["events"]) if sp.name == name
        and (sp.args.get("rid") if by_arg else sp.id) in rids])


def kv_stage_ms(obs):
    """Median ``kvx.stage`` duration over the window's requests."""
    return _phase_ms(obs, "kvx.stage", by_arg=True)


def kv_wire_ms(obs):
    """Median duration of a window request's ``migrating`` phase (puts
    issued, to admission into its decode slot)."""
    return _phase_ms(obs, "migrating")


def req_queued_ms(obs):
    """Median duration of a window request's ``queued`` phase (submit to
    prefill start)."""
    return _phase_ms(obs, "queued")


def clock_gaps_ms(obs, name: str = "decode.model",
                  host: str = "perfbench.decode_step"):
    """(median |start gap|, median |end gap|) in ms between each ``name``
    span in the slice and the profiler's host range ``host`` that overlaps
    it most: how far apart the two clocks put the same call."""
    sl = obs.get("slice")
    ranges = [(s, e) for s, e, n in sl.host_ranges if n == host] \
        if sl is not None else []
    starts, ends = [], []
    for a, b in _in_slice(obs, name):
        best = max(ranges, key=lambda r: min(r[1], b) - max(r[0], a),
                   default=None)
        if best is not None and min(best[1], b) > max(best[0], a):
            starts.append(abs(best[0] - a))
            ends.append(abs(best[1] - b))
    if not starts:
        return None
    return _median_ms(starts), _median_ms(ends)


def span_medians_ms(obs) -> dict:
    """Median duration in ms of each slice span that lies in the profiled
    slice, and (as ``req.<phase>``) of each lifeline phase of the window's
    requests."""
    pt, sl = _trace(obs), obs.get("slice")
    if pt is None:
        return {}
    t0, rids = pt["trace_start_ns"], window_requests(obs)
    wall_us = sl.wall_s * 1e6 if sl is not None else -1.0
    acc = defaultdict(list)
    for sp in spans(pt["events"]):
        if sp.id is None:
            if 0.0 <= to_slice_us(sp.start, t0) \
                    and to_slice_us(sp.end, t0) <= wall_us:
                acc[sp.name].append(sp.us)
        elif sp.id in rids:
            acc["req." + sp.name].append(sp.us)
    return {name: _median_ms(v) for name, v in sorted(acc.items())}


def idle_by_span(obs) -> list:
    """The slice's idle device seconds between device operations, summed
    by the innermost program span covering each gap's midpoint ("between
    spans" where none does), largest first."""
    pt, sl = _trace(obs), obs.get("slice")
    if pt is None or sl is None:
        return []
    t0 = pt["trace_start_ns"]
    sps = sorted((to_slice_us(sp.start, t0), to_slice_us(sp.end, t0),
                  sp.name) for sp in spans(pt["events"]) if sp.id is None)
    acc = defaultdict(float)
    active, i = [], 0
    for (_, a), (b, _) in zip(sl._union, sl._union[1:]):
        mid = (a + b) / 2               # the gaps come in time order
        while i < len(sps) and sps[i][0] <= mid:
            active.append(sps[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        best = min(active, key=lambda s: s[1] - s[0], default=None)
        acc["between spans" if best is None else best[2]] += (b - a) / 1e6
    return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])
