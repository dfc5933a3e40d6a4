"""Fleet metrics: latency percentiles, goodput, wire accounting.

A copy of ``repro/serve/frontend/metrics.py`` (pure Python, over the port's
scheduler records): the port keeps its own so that it imports nothing of
the JAX package.

Everything here is derived from the schedulers' per-request records — no
separate measurement path, so the numbers cannot drift from what actually
ran.  All latencies are *frontend-visible*: measured from the request's
``arrival_step`` (the open-loop clock), so queue time before prefill counts
— the satellite fix that makes overload measurable at all (a queue-blind
TTFD looks great while requests rot in the queue).

Definitions:

- **TTFD** — arrival -> first decode token (``admit_step - arrival_step``
  in scheduler steps; ``t_admit - t_arrival`` on the modeled comm clock).
- **e2e** — arrival -> finish.
- **goodput** — requests that finished AND met their class's TTFD deadline,
  divided by everything *offered* (including shed requests).  Offered load
  is the denominator on purpose: shedding trades completed-late for
  rejected-fast, and goodput must show that trade, not hide it.
- **cross-pod wire bytes** — migration bytes whose block home and decode
  PE were in different pods (dcn tier, host-proxy ring): the quantity
  prefix-affinity routing exists to remove.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.serve.frontend import slo as slo_mod
from repro_torch.serve.scheduler import FINISHED, RECOVERED, SHED


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile (q in [0, 100])."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] * (1 - frac) + s[hi] * frac)


def _latency_block(ttfd_steps, ttfd_model_s, e2e_steps) -> dict:
    return {
        "ttfd_p50_steps": percentile(ttfd_steps, 50),
        "ttfd_p99_steps": percentile(ttfd_steps, 99),
        "ttfd_p50_model_s": percentile(ttfd_model_s, 50),
        "ttfd_p99_model_s": percentile(ttfd_model_s, 99),
        "e2e_p50_steps": percentile(e2e_steps, 50),
        "e2e_p99_steps": percentile(e2e_steps, 99),
        "count": len(ttfd_steps),
    }


def collect(pods, *, classes: Optional[Dict] = None,
            elapsed_steps: Optional[int] = None) -> dict:
    """Roll every pod's request records up into one fleet report (plain
    JSON-able dict — benchmarks dump it verbatim)."""
    classes = slo_mod.CLASSES if classes is None else classes
    per_class: Dict[str, dict] = {}
    ttfd_all: List[float] = []
    ttfd_model_all: List[float] = []
    ttfd_first_block_all: List[float] = []
    e2e_all: List[float] = []
    offered = completed = shed = good = 0
    per_pod = {}
    for pod in pods:
        st = pod.sched.stats
        per_pod[pod.name] = {
            "prefills": st.prefills,
            "migrations": st.migrations,
            "admissions": st.admissions,
            "preempts": st.preempts,
            "resumes": st.resumes,
            "sheds": st.sheds,
            "bytes_migrated": st.bytes_migrated,
            "bytes_cross_pod": st.bytes_cross_pod,
            "bytes_wire_saved": st.bytes_wire_saved,
            "stream_chunks": st.stream_chunks,
            "prefix_hits": st.prefix_hits,
            "stalls": {"pool": st.stalled_on_pool,
                       "slots": st.stalled_on_slots,
                       "streams": st.stalled_on_streams},
            "recovery": {"remigrated": st.remigrated,
                         "recomputed": st.recomputed,
                         "replayed_tokens": st.replayed_tokens,
                         "recovery_p50_steps": percentile(
                             st.recovery_steps, 50),
                         "recovery_p99_steps": percentile(
                             st.recovery_steps, 99),
                         "recovered_requests": len(st.recovery_steps)},
            "load": pod.load(),
        }
        for req in pod.sched.requests.values():
            if req.state == RECOVERED:
                # the record lives on under a new rid on another pod (or
                # re-routed at drain) — counting it here would double-count
                # the request against offered load
                continue
            offered += 1
            cls = slo_mod.resolve(req.slo, classes)
            bucket = per_class.setdefault(
                cls.name, {"offered": 0, "completed": 0, "shed": 0,
                           "good": 0, "preempted": 0,
                           "_ttfd": [], "_ttfd_model": [], "_e2e": []})
            bucket["offered"] += 1
            bucket["preempted"] += req.preemptions
            if req.state == SHED:
                shed += 1
                bucket["shed"] += 1
                continue
            if req.state != FINISHED:
                continue                      # drained run: should not happen
            completed += 1
            bucket["completed"] += 1
            ttfd = req.admit_step - req.arrival_step
            ttfd_model = req.t_admit - req.t_arrival
            e2e = req.finish_step - req.arrival_step
            bucket["_ttfd"].append(ttfd)
            bucket["_ttfd_model"].append(ttfd_model)
            bucket["_e2e"].append(e2e)
            ttfd_all.append(ttfd)
            ttfd_model_all.append(ttfd_model)
            if req.first_block_step >= 0:
                ttfd_first_block_all.append(
                    req.first_block_step - req.arrival_step)
            e2e_all.append(e2e)
            if ttfd <= cls.ttfd_deadline:
                good += 1
                bucket["good"] += 1
    for name, b in per_class.items():
        b.update(_latency_block(b.pop("_ttfd"), b.pop("_ttfd_model"),
                                b.pop("_e2e")))
        b["goodput"] = b["good"] / b["offered"] if b["offered"] else 0.0
    report = {
        "offered": offered,
        "completed": completed,
        "shed": shed,
        "good": good,
        "goodput": good / offered if offered else 0.0,
        "latency": _latency_block(ttfd_all, ttfd_model_all, e2e_all),
        # time-to-first-resident-block percentiles (additive keys — the
        # device-op PR's satellite stat; equals admission under the barrier
        # protocol, strictly earlier under fused admission)
        "ttfd_first_block": {
            "p50_steps": percentile(ttfd_first_block_all, 50),
            "p99_steps": percentile(ttfd_first_block_all, 99),
            "count": len(ttfd_first_block_all),
        },
        "by_class": per_class,
        "by_pod": per_pod,
        "wire": {
            "bytes_migrated": sum(p["bytes_migrated"]
                                  for p in per_pod.values()),
            "bytes_cross_pod": sum(p["bytes_cross_pod"]
                                   for p in per_pod.values()),
            "bytes_wire_saved": sum(p["bytes_wire_saved"]
                                    for p in per_pod.values()),
        },
        "preempts": sum(p["preempts"] for p in per_pod.values()),
        "resumes": sum(p["resumes"] for p in per_pod.values()),
        "recovered": {
            "remigrated": sum(p["recovery"]["remigrated"]
                              for p in per_pod.values()),
            "recomputed": sum(p["recovery"]["recomputed"]
                              for p in per_pod.values()),
            "replayed_tokens": sum(p["recovery"]["replayed_tokens"]
                                   for p in per_pod.values()),
            "recovered_requests": sum(p["recovery"]["recovered_requests"]
                                      for p in per_pod.values()),
        },
    }
    if elapsed_steps:
        report["elapsed_steps"] = elapsed_steps
        report["goodput_per_step"] = good / elapsed_steps
    return report
