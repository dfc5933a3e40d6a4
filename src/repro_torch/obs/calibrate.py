"""Model-calibration layer: join measured wall clock against modeled cost.

Counterpart of ``repro/obs/calibrate.py``.

The profiler (``repro_torch.obs.prof``) produces :class:`~repro_torch.obs.prof.ProfSample`
pairs — measured ``wall_s`` next to the analytic model's ``model_s`` for the
same region — and ``source="wallclock"`` telemetry buckets next to the
``"model"`` stream.  This module turns both into a *divergence report*:

- per (op, tier, log2-size-bucket, work_items) bucket: sample count, wall
  and model statistics, and ratio (wall/model) percentiles where the model
  prices the region at all;
- the worst-diverging buckets ranked by ``|log(ratio)|`` — an integer-factor
  divergence in either direction is the headline finding (NVSHMEM-style
  analyses show exactly that across message-size regimes);
- coverage: how much measured wall time the model does not price at all
  (``model_s == 0`` regions — e.g. pure prefill compute), reported honestly
  instead of folded into a ratio;
- a sink-level join over telemetry keys present in BOTH provenance streams
  (the benchmark ``best_of(record=...)`` path lands here);
- a per-segment measured overlay for the critical-path analyzer and a
  ``measured`` Chrome-trace track (instants on deterministic step-clock
  timestamps; wall seconds ride in ``args`` only — the export validator
  enforces that no wall-clock value reaches a ``ts`` field).

Everything here is pure arithmetic over samples: given a canned sample file
the report is deterministic byte for byte.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import prof as prof_mod
from repro_torch.obs.tracer import STEP_QUANTUM
from repro_torch.tune import telemetry as telemetry_mod

#: profiler op -> critical-path segment (repro_torch.obs.critical.SEGMENTS) for
#: the measured overlay; unlisted ops fall into "other"
OP_SEGMENT = {
    "serve_decode": "compute",
    "serve_prefill": "compute",
    "paged_attn": "compute",
    "stream_flush": "wire",
    "migrate_flush": "wire",
    "flush": "wire",
}

BucketKey = Tuple[str, str, int, int]     # (op, tier, size_bucket, work_items)


def size_bucket(nbytes: int) -> int:
    """log2 size class (0 for empty regions) — same binning as the
    telemetry size histogram."""
    return max(0, int(nbytes).bit_length() - 1) if nbytes > 0 else 0


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (deterministic,
    no interpolation surprises across platforms)."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      int(math.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[rank]


def _stats(vals: List[float]) -> dict:
    s = sorted(vals)
    return {
        "n": len(s),
        "mean": (sum(s) / len(s)) if s else 0.0,
        "p50": _percentile(s, 50.0),
        "p90": _percentile(s, 90.0),
        "max": s[-1] if s else 0.0,
        "total": sum(s),
    }


def report_from_samples(samples: Iterable[prof_mod.ProfSample], *,
                        worst: int = 8) -> dict:
    """The divergence report (JSON-able, deterministic given the samples)."""
    samples = list(samples)
    groups: Dict[BucketKey, List[prof_mod.ProfSample]] = {}
    for s in samples:
        groups.setdefault(
            (s.op, s.tier, size_bucket(s.nbytes), s.work_items),
            []).append(s)

    buckets = []
    for (op, tier, sb, wi) in sorted(groups):
        rows = groups[(op, tier, sb, wi)]
        walls = [r.wall_s for r in rows]
        models = [r.model_s for r in rows]
        ratios = sorted(r.wall_s / r.model_s for r in rows
                        if r.model_s > 0.0 and r.wall_s > 0.0)
        buckets.append({
            "op": op,
            "tier": tier,
            "size_bucket": sb,
            "size_bytes": 1 << sb,
            "work_items": wi,
            "n": len(rows),
            "modeled_n": sum(1 for r in rows if r.model_s > 0.0),
            "wall": _stats(walls),
            "model": _stats(models),
            "ratio": ({
                "p50": _percentile(ratios, 50.0),
                "p90": _percentile(ratios, 90.0),
                "max": ratios[-1],
            } if ratios else None),
        })

    populated = [b for b in buckets if b["ratio"] is not None]
    worst_rows = sorted(
        populated,
        key=lambda b: (-abs(math.log(max(b["ratio"]["p50"], 1e-300))),
                       b["op"], b["tier"], b["size_bucket"],
                       b["work_items"]))[:worst]

    wall_total = sum(s.wall_s for s in samples)
    model_total = sum(s.model_s for s in samples)
    unmodeled = sum(s.wall_s for s in samples if s.model_s <= 0.0)
    return {
        "schema_version": 1,
        "samples": len(samples),
        "buckets": buckets,
        "populated_buckets": len(populated),
        "worst": [
            {"op": b["op"], "tier": b["tier"],
             "size_bucket": b["size_bucket"],
             "work_items": b["work_items"],
             "ratio_p50": b["ratio"]["p50"], "n": b["n"]}
            for b in worst_rows
        ],
        "coverage": {
            "wall_s": wall_total,
            "model_s": model_total,
            "unmodeled_wall_s": unmodeled,
            "unmodeled_wall_frac": (unmodeled / wall_total
                                    if wall_total > 0 else 0.0),
        },
    }


def sink_join(sink: telemetry_mod.TelemetrySink, *,
              base: str = telemetry_mod.MODEL_SOURCE,
              other: str = telemetry_mod.WALLCLOCK_SOURCE) -> List[dict]:
    """Join telemetry keys present in BOTH provenance streams: mean modeled
    vs mean measured seconds per (op, path, tier, work_items).  This is the
    coarse sink-level view (no per-size pairing); the profiler's paired
    samples give the fine-grained one."""
    sources = getattr(sink, "sources", None)
    if not sources:
        return []
    base_map = sources.get(base, {})
    other_map = sources.get(other, {})
    out = []
    for key in sorted(set(base_map) & set(other_map)):
        mb, ob = base_map[key], other_map[key]
        mean_b, mean_o = mb.mean_time(), ob.mean_time()
        op, path, tier, wi = key
        out.append({
            "op": op, "path": path, "tier": tier, "work_items": wi,
            base: {"n": mb.count, "mean": mean_b},
            other: {"n": ob.count, "mean": mean_o},
            "ratio": (mean_o / mean_b) if mean_b > 0 else None,
        })
    return out


def measured_overlay(samples: Iterable[prof_mod.ProfSample]) -> dict:
    """Per-critical-path-segment measured wall seconds — the overlay the
    analyzer prints next to its step-clocked segment attribution."""
    seg: Dict[str, dict] = {}
    for s in samples:
        name = OP_SEGMENT.get(s.op, "other")
        row = seg.setdefault(name, {"wall_s": 0.0, "model_s": 0.0, "n": 0})
        row["wall_s"] += s.wall_s
        row["model_s"] += s.model_s
        row["n"] += 1
    return {k: seg[k] for k in sorted(seg)}


def measured_track_events(samples: Iterable[prof_mod.ProfSample]) -> List[dict]:
    """Chrome-trace instants for the ``measured`` track.

    Timestamps are STEP-CLOCKED (``step*1000 + seq``, seq = arrival order
    within the step, saturating like the deterministic clock) so the track
    aligns with the rest of the trace; the measured wall/model microseconds
    ride only in ``args`` — never in ``ts`` — which keeps the export
    validator's integral-timestamp rule intact."""
    events = []
    seq: Dict[int, int] = {}
    for s in samples:
        k = seq.get(s.step, 0)
        seq[s.step] = k + 1
        events.append({
            "name": s.op, "cat": "measured", "ph": "i", "s": "t",
            "pid": "measured", "tid": s.op,
            "ts": s.step * STEP_QUANTUM + min(k, STEP_QUANTUM - 1),
            "args": {
                "step": s.step,
                "nbytes": s.nbytes,
                "path": s.path,
                "tier": s.tier,
                "work_items": s.work_items,
                "wall_us": s.wall_s * 1e6,
                "model_us": s.model_s * 1e6,
            },
        })
    events.sort(key=lambda e: (e["tid"], e["ts"]))
    return events


def render(report: dict, *, sink_rows: Optional[List[dict]] = None) -> str:
    """Human-readable divergence report for the CLI."""
    lines = []
    cov = report["coverage"]
    lines.append(f"calibration: {report['samples']} measured samples, "
                 f"{report['populated_buckets']} populated "
                 f"(op, tier, size, wi) buckets")
    lines.append(f"  measured wall {cov['wall_s'] * 1e3:.3f} ms   "
                 f"modeled {cov['model_s'] * 1e3:.3f} ms   "
                 f"unmodeled wall {cov['unmodeled_wall_frac'] * 100:.1f}%")
    if report["worst"]:
        lines.append("  worst divergence (ratio = wall/model, p50):")
        for b in report["worst"]:
            lines.append(
                f"    {b['op']:<16} tier={b['tier']:<5} "
                f"2^{b['size_bucket']:<2}B wi={b['work_items']:<4} "
                f"ratio {b['ratio_p50']:9.3f}  (n={b['n']})")
    else:
        lines.append("  no model-priced buckets measured (nothing to join)")
    if sink_rows:
        lines.append("  sink join (mean measured / mean modeled):")
        for r in sink_rows:
            ratio = r["ratio"]
            lines.append(
                f"    {r['op']:<16} {r['path']}/{r['tier']}/wi{r['work_items']}"
                f"  ratio {ratio:9.3f}" if ratio is not None else
                f"    {r['op']:<16} {r['path']}/{r['tier']}/wi{r['work_items']}"
                f"  (model mean 0)")
    return "\n".join(lines)
