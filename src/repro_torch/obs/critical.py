"""Per-request critical-path reconstruction and fleet TTFD attribution.

Counterpart of ``repro/obs/critical.py``.

The tracer gives every request a causal lifeline (``cat="req"`` async
spans, ``export.request_chains``); this module *consumes* it: each chain becomes a
critical path whose time is attributed exactly to five segments —

======== ====================================================================
queue    waiting for a resource: intake queue (``queued``), a decode slot or
         stream word (``staged``), a slot while the wire drains (``parked``),
         plus the shed span of rejected requests
wire     modeled bytes-in-flight: the ``streaming`` installment ramp, and the
         modeled wire window of the ``migrating`` span (``wire_steps`` —
         fused migrations refine it with the *observed* ``first_block_step``)
signal_  the ``migrating`` remainder past the wire window: the decode PE
wait     watching the slot/stream signal word ramp (flush latency, another
         request's admission completing this one's queue prefix, device
         ``signal_wait_until`` spins)
compute  ``prefill`` and ``decoding`` spans
preempt  ``preempted`` spans (parked in the pool between decode bursts)
======== ====================================================================

Durations are **boundary-attributed**: each phase runs from its begin to the
next phase's begin (the last runs to its own end), so the segment sum equals
the end-to-end span *exactly* — the invariant the stressed-fleet tests gate
on.  The migrating span is split wire/signal-wait inside those boundaries.

``analyze`` rolls paths up into the "where does p99 TTFD go" fleet report
with what-if estimates (e.g. the zero-wire TTFD bound: the p99 if every
wire segment cost nothing).  ``python -m repro_torch.obs.analyze trace.json``
(``obs/analyze.py``) is the offline CLI over an exported trace.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs import export as export_mod
from repro_torch.obs.tracer import STEP_QUANTUM

#: attribution buckets, in report order
SEGMENTS = ("queue", "wire", "signal_wait", "compute", "preemption")

#: lifeline phase -> segment; ``migrating`` is split wire/signal_wait
PHASE_SEGMENT = {
    "shed": "queue",
    "queued": "queue",
    "prefill": "compute",
    "staged": "queue",
    "streaming": "wire",
    "parked": "queue",
    "decoding": "compute",
    "preempted": "preemption",
}


def _migrating_split(entry: dict, dur: float) -> tuple:
    """(wire_ticks, signal_wait_ticks) for one ``migrating`` span.

    The modeled wire window is ``wire_steps`` (the scheduler's admission
    gate: ``admit_ready_step - migrate_step``).  Fused migrations gate on
    the FIRST block's signal, and the scheduler records the step that block
    was *observed* resident (``first_block_step`` — possibly earlier than
    the gate, when another request's admission flush completed this one's
    queue prefix); when present it overrides the model, so fused requests
    show the true wire / signal-wait split.  Everything past the wire
    window until admission is the decode PE waiting on the signal word.
    """
    args = entry["args"]
    wire = None
    if args.get("protocol") == "fused":
        fbs = args.get("first_block_step", -1)
        if isinstance(fbs, (int, float)) and fbs >= 0:
            migrate_step = int(entry["t0"] // STEP_QUANTUM)
            wire = (float(fbs) - migrate_step) * STEP_QUANTUM
    if wire is None:
        wire = float(args.get("wire_steps", 0)) * STEP_QUANTUM
    wire = max(0.0, min(float(dur), wire))
    return wire, float(dur) - wire


def critical_path(chain: List[dict]) -> dict:
    """One request's critical path from its reconstructed phase chain.

    Returns::

        {"segments": {segment: ticks}, "phases": [{"phase", "ticks"}],
         "t0", "t1", "e2e_ticks", "ttfd_ticks" (None before first decode),
         "ttfd_segments": {segment: ticks up to the first decoding begin},
         "outcome", "preemptions", "complete": bool, "gaps": [...]}

    ``sum(segments.values()) == e2e_ticks`` holds exactly for a complete
    chain (boundary attribution, see module docstring); ``complete`` is
    False when any span is still open (windowed/truncated trace).
    """
    segments = {s: 0.0 for s in SEGMENTS}
    ttfd_segments = {s: 0.0 for s in SEGMENTS}
    phases: List[dict] = []
    if not chain:
        return {"segments": segments, "ttfd_segments": ttfd_segments,
                "phases": phases, "t0": None, "t1": None, "e2e_ticks": 0.0,
                "ttfd_ticks": None, "outcome": None, "preemptions": 0,
                "complete": False, "gaps": []}
    complete = all(e["t1"] is not None for e in chain)
    t_decode0 = next((e["t0"] for e in chain if e["phase"] == "decoding"),
                     None)
    for i, entry in enumerate(chain):
        t0 = entry["t0"]
        t_end = chain[i + 1]["t0"] if i + 1 < len(chain) else entry["t1"]
        if t_end is None:                      # open tail span
            t_end = t0
        dur = max(0.0, float(t_end) - float(t0))
        if entry["phase"] == "migrating":
            wire, sw = _migrating_split(entry, dur)
            parts = (("wire", wire), ("signal_wait", sw))
        else:
            seg = PHASE_SEGMENT.get(entry["phase"], "compute")
            parts = ((seg, dur),)
        for seg, ticks in parts:
            segments[seg] += ticks
            if t_decode0 is not None and t0 < t_decode0:
                # TTFD prefix: clip the phase to the first decoding begin
                clip = min(float(t_end), float(t_decode0)) - float(t0)
                if dur > 0:
                    ttfd_segments[seg] += ticks * max(0.0, clip) / dur
                else:
                    ttfd_segments[seg] += 0.0
        phases.append({"phase": entry["phase"], "ticks": dur})
    t0 = float(chain[0]["t0"])
    last = chain[-1]
    t1 = float(last["t1"] if last["t1"] is not None else last["t0"])
    args_last = last["args"]
    return {
        "segments": segments,
        "ttfd_segments": ttfd_segments,
        "phases": phases,
        "t0": t0,
        "t1": t1,
        "e2e_ticks": t1 - t0,
        "ttfd_ticks": (None if t_decode0 is None
                       else float(t_decode0) - t0),
        "outcome": args_last.get("outcome"),
        "preemptions": args_last.get("preemptions", 0),
        "complete": complete,
        "gaps": export_mod.chain_gaps(chain),
    }


def device_waits(events) -> Dict[int, dict]:
    """Per-rid device-side wait attribution from the ``kvx`` instants the
    fused protocol emits: ``admit_fused`` (the first-block admission gate)
    and ``consume`` (per-block ``device_signal_wait`` batches inside
    decode).  ``{rid: {"consumed_blocks", "consume_events", "fused_admit"}}``
    — threads the fused protocol's device spans into each request's path
    record."""
    out: Dict[int, dict] = {}
    for ev in events:
        if ev.cat != "kvx" or ev.ph != "i":
            continue
        rid = (ev.args or {}).get("rid")
        if rid is None:
            continue
        rec = out.setdefault(int(rid), {"consumed_blocks": 0,
                                        "consume_events": 0,
                                        "fused_admit": False})
        if ev.name == "consume":
            rec["consume_events"] += 1
            rec["consumed_blocks"] += int(ev.args.get("blocks", 0))
        elif ev.name == "admit_fused":
            rec["fused_admit"] = True
    return out


def fleet_paths(chains: Dict[int, List[dict]],
                events=None) -> Dict[int, dict]:
    """Critical path per request; when the raw event stream is supplied the
    device-wait attribution (``device_waits``) is merged into each path."""
    paths = {rid: critical_path(chain) for rid, chain in chains.items()}
    if events is not None:
        dev = device_waits(events)
        for rid, rec in dev.items():
            if rid in paths:
                paths[rid]["device"] = rec
    return paths


def _percentile(xs: List[float], q: float) -> float:
    """Interpolated percentile (mirrors ``serve.frontend.metrics``) without
    importing the serving stack into the offline analyzer."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1 - frac) + xs[hi] * frac)


def analyze(chains: Dict[int, List[dict]], events=None, *,
            q: float = 99.0, measured=None) -> dict:
    """The "where does p99 TTFD go" fleet report.

    Aggregates every admitted request's TTFD-prefix segments, names the
    order-statistic request behind the p-``q`` TTFD with its own breakdown,
    and computes what-if bounds: for each segment, the p-``q`` TTFD if that
    segment cost zero (``zero_wire_p99_steps`` is the headline — the bound
    a perfect interconnect could reach without touching the scheduler).
    All times are in scheduler steps (ticks / STEP_QUANTUM).

    ``measured`` optionally carries wall-clock profiler samples
    (:class:`repro_torch.obs.prof.ProfSample`); when given, the report grows a
    ``measured_overlay`` — per-segment *measured* wall seconds next to the
    step-clocked attribution, so "wire is 60% of TTFD" can be sanity-checked
    against what a real clock saw for the same segments."""
    paths = fleet_paths(chains, events)
    admitted = {rid: p for rid, p in paths.items()
                if p["ttfd_ticks"] is not None}
    shed = sum(1 for p in paths.values() if p["outcome"] == "shed")
    incomplete = sum(1 for p in paths.values() if not p["complete"])
    gaps = sum(len(p["gaps"]) for p in paths.values())

    ttfd = {rid: p["ttfd_ticks"] / STEP_QUANTUM
            for rid, p in admitted.items()}
    xs = list(ttfd.values())
    seg_totals = {s: 0.0 for s in SEGMENTS}
    for p in admitted.values():
        for s in SEGMENTS:
            seg_totals[s] += p["ttfd_segments"][s] / STEP_QUANTUM
    total = sum(seg_totals.values()) or 1.0

    # the request actually sitting at the p-q order statistic
    worst = None
    if xs:
        target = _percentile(xs, q)
        rid = min(ttfd, key=lambda r: (abs(ttfd[r] - target), r))
        worst = {
            "rid": rid,
            "ttfd_steps": ttfd[rid],
            "segments_steps": {s: admitted[rid]["ttfd_segments"][s]
                               / STEP_QUANTUM for s in SEGMENTS},
            "preemptions": admitted[rid]["preemptions"],
        }

    what_if = {}
    for s in ("wire", "signal_wait", "queue"):
        bound = [t - p["ttfd_segments"][s] / STEP_QUANTUM
                 for t, p in zip(xs, admitted.values())]
        what_if[f"zero_{s}_p{int(q)}_steps"] = _percentile(bound, q)

    e2e = [p["e2e_ticks"] / STEP_QUANTUM for p in paths.values()
           if p["complete"]]
    dev_events = 0
    dev_spins = 0
    if events is not None:
        for ev in events:
            if ev.ph == "i" and str(ev.name).startswith("device_"):
                dev_events += 1
                dev_spins += int((ev.args or {}).get("spins", 0))
    overlay = None
    if measured is not None:
        from repro_torch.obs import calibrate as calibrate_mod
        overlay = calibrate_mod.measured_overlay(measured)
    return {
        "requests": len(paths),
        "admitted": len(admitted),
        "shed": shed,
        "incomplete_paths": incomplete,
        "chain_gaps": gaps,
        "ttfd": {
            "p50_steps": _percentile(xs, 50.0),
            f"p{int(q)}_steps": _percentile(xs, q),
            "mean_steps": (sum(xs) / len(xs)) if xs else 0.0,
        },
        "ttfd_segments_steps": seg_totals,
        "ttfd_segment_share": {s: seg_totals[s] / total for s in SEGMENTS},
        f"p{int(q)}_request": worst,
        "what_if": what_if,
        "e2e": {
            "p50_steps": _percentile(e2e, 50.0),
            f"p{int(q)}_steps": _percentile(e2e, q),
        },
        "device": {"events": dev_events, "spins": dev_spins},
        "measured_overlay": overlay,
    }


def analyze_tracer(tracer, *, q: float = 99.0, measured=None) -> dict:
    """:func:`analyze` straight off a live :class:`SpanTracer`."""
    return analyze(export_mod.request_chains(tracer), tracer.events, q=q,
                   measured=measured)


def analyze_doc(doc: dict, *, q: float = 99.0, measured=None) -> dict:
    """:func:`analyze` over a loaded Chrome-trace JSON document."""
    events = export_mod.events_from_doc(doc)
    return analyze(export_mod._chains_from_events(events), events, q=q,
                   measured=measured)
