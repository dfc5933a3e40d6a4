"""Chrome-trace / Perfetto export, trace validation, and chain reconstruction.

Counterpart of ``repro/obs/export.py``.  ``chrome_trace`` serializes a
:class:`~repro_torch.obs.tracer.SpanTracer` into the Trace Event Format
dict that ``chrome://tracing`` and https://ui.perfetto.dev load directly:
one process track per pod (plus ``core`` and ``fleet``), one thread track
per PE / subsystem, per-request causal lifelines as async spans
(``b``/``e`` correlated by ``cat="req"`` + request id), migrations as flow
arrows (``s``/``f``) from the source PE's issue slice to the destination
PE's admit, and, when the profiler ran, its step-clocked ``measured``
track.

``validate`` checks the structural invariants every export must satisfy
(ids/timestamps present, slice stacks balanced, async spans and flows
paired, step-clocked ``ts``).  ``request_chains`` rebuilds one request's
arrival→…→finish phase sequence from the raw events.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.tracer import SpanTracer, TraceEvent

#: schema version stamped into exported metadata
TRACE_SCHEMA_VERSION = 1


def _sort_key(pid) -> tuple:
    # stable track order: pods first (pod0, pod1, ...), then named tracks
    s = str(pid)
    if s.startswith("pod") and s[3:].isdigit():
        return (0, int(s[3:]), s)
    return (1, 0, s)


def _event_json(ev: TraceEvent) -> dict:
    obj = {
        "name": ev.name,
        "cat": ev.cat,
        "ph": ev.ph,
        "ts": ev.ts,
        "pid": str(ev.pid),
        "tid": str(ev.tid),
    }
    if ev.id is not None:
        obj["id"] = str(ev.id)
    if ev.args:
        obj["args"] = ev.args
    return obj


def chrome_trace_events(span_events, *, dropped: int = 0,
                        other: Optional[dict] = None,
                        measured: Optional[List[dict]] = None) -> dict:
    """Trace-Event-Format document from an explicit event sequence — the
    serializer behind :func:`chrome_trace`, reused by the flight recorder
    for windowed postmortem dumps.  ``other`` merges extra keys into
    ``otherData`` (e.g. the dump reason).

    ``measured`` appends a pre-serialized ``measured`` track
    (:func:`repro_torch.obs.calibrate.measured_track_events`): wall-clock profiler
    instants on step-clocked timestamps.  The track is additive — omitting
    it yields a byte-identical document, which is what keeps profiling-off
    exports bitwise."""
    events: List[dict] = []
    span_events = list(span_events)
    measured = list(measured or [])
    # metadata naming: one process_name per pid, sorted for stable diffs
    pids = sorted({ev.pid for ev in span_events}, key=_sort_key)
    if measured:
        pids.append("measured")
    for pid in pids:
        events.append({"name": "process_name", "ph": "M", "pid": str(pid),
                       "args": {"name": str(pid)}})
    seen_tids = set()
    for ev in span_events:
        key = (ev.pid, ev.tid)
        if key not in seen_tids:
            seen_tids.add(key)
            events.append({"name": "thread_name", "ph": "M",
                           "pid": str(ev.pid), "tid": str(ev.tid),
                           "args": {"name": str(ev.tid)}})
        events.append(_event_json(ev))
    for ev in measured:
        key = (ev["pid"], ev["tid"])
        if key not in seen_tids:
            seen_tids.add(key)
            events.append({"name": "thread_name", "ph": "M",
                           "pid": str(ev["pid"]), "tid": str(ev["tid"]),
                           "args": {"name": str(ev["tid"])}})
        events.append(ev)
    other_data = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "clock": "step",                # ts = step * 1000 + sub-tick
        "dropped_events": dropped,
    }
    if measured:
        other_data["measured_samples"] = len(measured)
    if other:
        other_data.update(other)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other_data,
    }


def chrome_trace(tracer: SpanTracer, *,
                 measured: Optional[List[dict]] = None) -> dict:
    """Full Trace-Event-Format document (``traceEvents`` + metadata)."""
    return chrome_trace_events(tracer.events, dropped=tracer.dropped,
                               measured=measured)


def write_chrome_trace(tracer: SpanTracer, path: str, *,
                       measured: Optional[List[dict]] = None) -> dict:
    doc = chrome_trace(tracer, measured=measured)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


# --------------------------------------------------------------------------
# validation (CI gate b)
# --------------------------------------------------------------------------

def validate(doc: dict, *, warnings: Optional[list] = None) -> List[str]:
    """Structural schema check; returns a list of violations (empty = valid).

    Invariants:

    - every event has ``ph``/``name``/``pid``/``tid``; non-metadata events
      have a numeric ``ts`` that is non-decreasing per (pid, tid) track
    - every ``ts`` (and ``dur``, when present) is an INTEGER value: the
      deterministic step clock only produces ``step*1000 + sub-tick``, so a
      fractional timestamp means a wall-clock (``ProfClock``) value leaked
      into a deterministic field — measured seconds belong in ``args``
      (the ``measured`` track keeps wall time there for exactly this rule)
    - ``B``/``E`` slice stacks balance per (pid, tid) and never go negative
    - ``b``/``e`` async spans balance per (cat, id, name), end-after-begin
    - every flow start (``s``) has a matching finish (``f``) with the same
      id, and vice versa
    - async/flow events carry an ``id``

    Tracer-bound truncation (``otherData.dropped_events > 0``) is surfaced
    as a ``"warning: ..."`` entry: a truncated trace is structurally valid
    (ends of open spans are force-admitted) but spans may be *missing*, so
    chain reconstruction over it cannot be trusted.  Pass ``warnings=[]``
    to collect warnings separately and keep the return value errors-only.
    """
    errors: List[str] = []
    warn_sink = errors if warnings is None else warnings
    dropped = (doc.get("otherData") or {}).get("dropped_events", 0)
    if dropped:
        warn_sink.append(
            f"warning: tracer dropped {dropped} event(s) at its buffer "
            f"bound — spans may be missing; request-chain reconstruction "
            f"over this trace is untrustworthy")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return errors + ["traceEvents missing or not a list"]

    slice_stacks: Dict[tuple, List[str]] = {}
    async_open: Dict[tuple, int] = {}
    flow_starts: Dict[str, int] = {}
    flow_ends: Dict[str, int] = {}
    last_ts: Dict[tuple, float] = {}

    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None or "name" not in ev or "pid" not in ev:
            errors.append(f"event {i}: missing ph/name/pid")
            continue
        if ph == "M":
            continue
        if "tid" not in ev:
            errors.append(f"event {i} ({ev['name']}): missing tid")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i} ({ev['name']}): missing/non-numeric ts")
            continue
        if float(ts) != int(ts):
            errors.append(
                f"event {i} ({ev['name']}): non-integral ts {ts!r} — "
                f"wall-clock value leaked into a step-clocked field "
                f"(measured seconds belong in args, not ts)")
        dur = ev.get("dur")
        if dur is not None and (not isinstance(dur, (int, float))
                                or float(dur) != int(dur)):
            errors.append(
                f"event {i} ({ev['name']}): non-integral dur {dur!r} — "
                f"wall-clock value leaked into a step-clocked field")
        track = (ev["pid"], ev["tid"])
        if ts < last_ts.get(track, float("-inf")):
            errors.append(f"event {i} ({ev['name']}): ts regressed on "
                          f"track {track}")
        last_ts[track] = ts

        if ph == "B":
            slice_stacks.setdefault(track, []).append(ev["name"])
        elif ph == "E":
            stack = slice_stacks.get(track)
            if not stack:
                errors.append(f"event {i}: E '{ev['name']}' with empty "
                              f"stack on {track}")
            elif stack[-1] != ev["name"]:
                errors.append(f"event {i}: E '{ev['name']}' does not match "
                              f"open '{stack[-1]}' on {track}")
                stack.pop()
            else:
                stack.pop()
        elif ph in ("b", "e"):
            if "id" not in ev:
                errors.append(f"event {i} ({ev['name']}): async without id")
                continue
            key = (ev.get("cat"), ev["id"], ev["name"])
            if ph == "b":
                async_open[key] = async_open.get(key, 0) + 1
            else:
                n = async_open.get(key, 0)
                if n <= 0:
                    errors.append(f"event {i}: async end {key} before begin")
                else:
                    async_open[key] = n - 1
        elif ph == "s":
            if "id" not in ev:
                errors.append(f"event {i} ({ev['name']}): flow without id")
            else:
                flow_starts[ev["id"]] = flow_starts.get(ev["id"], 0) + 1
        elif ph == "f":
            if "id" not in ev:
                errors.append(f"event {i} ({ev['name']}): flow without id")
            else:
                flow_ends[ev["id"]] = flow_ends.get(ev["id"], 0) + 1

    for track, stack in slice_stacks.items():
        if stack:
            errors.append(f"unclosed slices on {track}: {stack}")
    for key, n in async_open.items():
        if n:
            errors.append(f"unclosed async span {key} (x{n})")
    for fid, n in flow_starts.items():
        if flow_ends.get(fid, 0) != n:
            errors.append(f"flow id {fid}: {n} starts, "
                          f"{flow_ends.get(fid, 0)} finishes")
    for fid, n in flow_ends.items():
        if fid not in flow_starts:
            errors.append(f"flow id {fid}: {n} finishes, 0 starts")
    return errors


# --------------------------------------------------------------------------
# per-request chain reconstruction
# --------------------------------------------------------------------------

def _chains_from_events(events) -> Dict[int, List[dict]]:
    chains: Dict[int, List[dict]] = {}
    open_phase: Dict[tuple, dict] = {}
    for ev in events:
        if ev.cat != "req" or ev.id is None:
            continue
        key = (ev.id, ev.name)
        if ev.ph == "b":
            entry = {"phase": ev.name, "t0": ev.ts, "t1": None,
                     "args": dict(ev.args or {})}
            chains.setdefault(ev.id, []).append(entry)
            open_phase[key] = entry
        elif ev.ph == "e":
            entry = open_phase.pop(key, None)
            if entry is not None:
                entry["t1"] = ev.ts
                entry["args"].update(ev.args or {})
    for chain in chains.values():
        chain.sort(key=lambda e: e["t0"])
    return chains


def request_chains(tracer: SpanTracer) -> Dict[int, List[dict]]:
    """Reconstruct each request's causal lifeline from ``cat="req"`` async
    spans: ``{rid: [{"phase", "t0", "t1", "args"}, ...]}`` ordered by begin
    timestamp.  ``args`` merges begin- and end-side attribution (end wins on
    key collision, so closing attribution like wire/queue/compute seconds
    lands on the phase that measured it)."""
    return _chains_from_events(tracer.events)


def events_from_doc(doc: dict) -> List[TraceEvent]:
    """Rehydrate :class:`TraceEvent` records from an exported (or loaded)
    Chrome-trace document — the offline entry into :func:`request_chains`
    and the critical-path analyzer (``python -m repro_torch.obs.analyze``).
    Metadata (``ph="M"``) records are skipped; async/flow ids round-trip
    back to ints (request ids are serialized as strings)."""
    out: List[TraceEvent] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        eid = ev.get("id")
        if isinstance(eid, str) and eid.lstrip("-").isdigit():
            eid = int(eid)
        out.append(TraceEvent(ph=ev.get("ph"), name=ev.get("name"),
                              cat=ev.get("cat"), ts=ev.get("ts"),
                              pid=ev.get("pid"), tid=ev.get("tid"),
                              id=eid, args=ev.get("args")))
    return out


def request_chains_doc(doc: dict) -> Dict[int, List[dict]]:
    """:func:`request_chains` over a loaded Chrome-trace JSON document."""
    return _chains_from_events(events_from_doc(doc))


def chain_gaps(chain: List[dict], *, slack: float = 1.0) -> List[tuple]:
    """Uncovered (t1_prev, t0_next) intervals in a request's phase chain —
    a gap-free lifeline (the causality tests' invariant) returns [].

    Phase transitions close the old span and open the new one on
    *consecutive* sub-ticks (the step clock advances once per event), so a
    begin within ``slack`` ticks of the covered frontier is contiguous;
    anything further means the request spent untraced time between phases.

    A still-open span (``t1 is None`` — a SHED/PREEMPTED/mid-flight request
    in a windowed or truncated trace) covers everything from its begin
    onward: the request is *in* that phase, so nothing after it is
    untraced.  Skipping such entries (the old behavior) left the covered
    frontier at the previous close and flagged phantom gaps against spans
    that sorted after the open one.
    """
    gaps = []
    covered_until = None
    for entry in chain:
        if covered_until is not None and entry["t0"] > covered_until + slack:
            gaps.append((covered_until, entry["t0"]))
        t1 = float("inf") if entry["t1"] is None else entry["t1"]
        covered_until = t1 if covered_until is None else max(covered_until,
                                                             t1)
    return gaps
