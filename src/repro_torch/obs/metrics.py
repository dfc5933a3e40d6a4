"""Metrics registry: per-fleet-step counters / gauges / histograms.

Counterpart of ``repro/obs/metrics.py``.

The span tracer (``obs.tracer``) answers "what happened to request 17?";
this module answers "what was the *system* doing at step 40?" — heap
fragmentation, proxy-ring occupancy and backpressure, KV-pool residency,
per-class goodput — snapshotted once per fleet step into a time series that
``--metrics out.json`` dumps next to the trace.

:class:`MetricsRegistry` is deliberately dumb storage (three dicts + a
sample loop); :func:`sample_fleet` is the one place that knows where each
number lives in the stack, so adding a gauge is a one-line change there.
"""
from __future__ import annotations

import json
from typing import Dict, List


def _log2_bucket(v: float) -> int:
    return max(0, int(v).bit_length() - 1) if v >= 1 else 0


class MetricsRegistry:
    """Counters (monotonic), gauges (point-in-time), log2 histograms, and a
    per-step time series of every gauge/counter sampled that step."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Dict[int, int]] = {}
        self.series: List[dict] = []          # one row per sampled step

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.hists.setdefault(name, {})
        b = _log2_bucket(value)
        h[b] = h.get(b, 0) + 1

    def sample(self, step: int) -> dict:
        """Append (and return) one time-series row: the current value of
        every gauge and counter, stamped with the fleet step."""
        row = {"step": step}
        row.update(self.gauges)
        row.update(self.counters)
        self.series.append(row)
        return row

    # ---------------------------------------------------------------- dump
    def snapshot(self) -> dict:
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": {k: {str(b): n for b, n in sorted(v.items())}
                           for k, v in sorted(self.hists.items())},
            "series": self.series,
        }

    def write(self, path: str) -> dict:
        doc = self.snapshot()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return doc


def sample_fleet(reg: MetricsRegistry, fleet, *, tracer=None) -> dict:
    """Read the whole stack's health gauges off a live Fleet and sample one
    time-series row (call once per fleet step, after the pods advance)."""
    from repro_torch.serve.frontend import slo as slo_mod
    from repro_torch.serve.scheduler import FINISHED, RECOVERED, SHED

    # --- symmetric heap: allocator pressure + fragmentation ---------------
    hs = fleet.heap.stats()
    reg.gauge("heap.bytes_in_use", hs["bytes_in_use"])
    reg.gauge("heap.bytes_free", hs["bytes_free"])
    frag = max((p["fragmentation"] for p in hs["pools"].values()),
               default=0.0)
    reg.gauge("heap.fragmentation_max", frag)
    reg.observe("heap.fragmentation", frag * 1024)   # log2 over milli-units

    # --- KV pool residency ------------------------------------------------
    ps = fleet.pool.stats()
    reg.gauge("pool.blocks_in_use", ps["blocks_in_use"])
    reg.gauge("pool.utilization", ps["utilization"])
    reg.gauge("pool.blocks_shared", ps["blocks_shared"])
    reg.gauge("pool.streams_active", ps["streams_active"])
    reg.gauge("pool.requests_resident", ps["requests_resident"])

    # --- host-proxy ring: occupancy + backpressure ------------------------
    if fleet.proxy is not None:
        ring = fleet.proxy.ring
        occ = ring.write_reserve - ring.consumed_published
        reg.gauge("proxy.ring_occupancy", occ)
        reg.gauge("proxy.ring_slots", ring.slots)
        reg.gauge("proxy.backpressure", fleet.proxy.backpressure)
        reg.observe("proxy.occupancy_hist", occ)

    # --- per-pod queue/slot pressure, fleet-wide class goodput ------------
    offered = {}
    good = {}
    shed = {}
    finished = {}
    recovered = 0
    for pod in fleet.pods + getattr(fleet, "dead_pods", []):
        sched = pod.sched
        reg.gauge(f"{pod.name}.queue_depth", len(sched.queue))
        reg.gauge(f"{pod.name}.waiting", pod.waiting())
        reg.gauge(f"{pod.name}.free_slots", pod.free_slots())
        reg.gauge(f"{pod.name}.occupancy", pod.occupancy())
        recovered += len(sched.stats.recovery_steps)
        for req in sched.requests.values():
            if req.state == RECOVERED:
                continue    # adopted elsewhere under a new rid — not offered
            cls = slo_mod.resolve(req.slo, fleet.classes)
            offered[cls.name] = offered.get(cls.name, 0) + 1
            if req.state == SHED:
                shed[cls.name] = shed.get(cls.name, 0) + 1
            elif req.state == FINISHED:
                finished[cls.name] = finished.get(cls.name, 0) + 1
                if (req.admit_step - req.arrival_step
                        <= cls.ttfd_deadline):
                    good[cls.name] = good.get(cls.name, 0) + 1
    for name, n in offered.items():
        n_shed = shed.get(name, 0)
        n_fin = finished.get(name, 0)
        n_good = good.get(name, 0)
        reg.gauge(f"class.{name}.offered", n)
        reg.gauge(f"class.{name}.good", n_good)
        reg.gauge(f"class.{name}.shed", n_shed)
        reg.gauge(f"class.{name}.goodput", n_good / n)
        # cumulative SLO ledger for the burn-rate monitor (obs.alerts):
        # terminal = requests with a final verdict, bad = the SLO-violating
        # subset (shed outright, or finished past the admission deadline)
        reg.gauge(f"class.{name}.finished", n_fin)
        reg.gauge(f"class.{name}.terminal", n_fin + n_shed)
        reg.gauge(f"class.{name}.bad", n_shed + (n_fin - n_good))

    # --- fault / recovery -------------------------------------------------
    fault = getattr(fleet.ctx, "fault", None)
    if fault is not None:
        reg.gauge("fault.dead_pes", len(fault.dead_pes))
        reg.gauge("fault.dcn_down", 1.0 if fault.dcn_down else 0.0)
        reg.gauge("fault.cancelled_ops", fleet.ctx.pending.stats.cancelled)
    # requests that came back from a fault: re-admitted to decode with
    # their pre-fault tokens replayed (the report's recovered_requests)
    reg.gauge("recovered_requests", recovered)

    # --- tracer health (self-observability) -------------------------------
    if tracer is not None and tracer.enabled:
        reg.gauge("trace.events", len(tracer.events))
        reg.gauge("trace.dropped", tracer.dropped)

    return reg.sample(fleet.elapsed_steps)
