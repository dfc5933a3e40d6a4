"""Offline critical-path analysis of an exported trace.

Counterpart of ``repro/obs/analyze.py``.

    python -m repro_torch.obs.analyze trace.json [--json report.json] [--q 99]
                                [--calibration samples.json]

Loads a Chrome-trace document written by ``--trace`` (or a flight-recorder
postmortem dump), validates it, reconstructs every request's critical path
(``repro_torch.obs.critical``), and prints the "where does p99 TTFD go" report:
per-segment attribution, the order-statistic request behind the p99, and
the what-if bounds (zero-wire / zero-signal-wait / zero-queue TTFD).

With ``--calibration`` pointing at a profiler sample file (written by
``--profile`` on the serve driver, ``repro_torch.obs.prof.Profiler.save``), the
report additionally carries the measured-vs-modeled divergence summary
(``repro_torch.obs.calibrate``) and a per-segment *measured* overlay next to the
step-clocked attribution.

Truncated traces (``otherData.dropped_events > 0``) are analyzed but loudly
flagged: with spans missing, chains can have phantom gaps and the segment
attribution is a lower bound, not the truth.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import calibrate, critical, export, prof as prof_mod


def _fmt_steps(x: float) -> str:
    return f"{x:8.1f}"


def render(report: dict, *, q: int, errors, warnings) -> str:
    lines = []
    lines.append(f"requests {report['requests']} "
                 f"(admitted {report['admitted']}, shed {report['shed']})")
    if warnings:
        for w in warnings:
            lines.append(f"!! {w}")
    if errors:
        lines.append(f"!! trace failed schema validation "
                     f"({len(errors)} error(s)); first: {errors[0]}")
    if report["incomplete_paths"]:
        lines.append(f"!! {report['incomplete_paths']} request(s) with "
                     f"still-open spans (windowed/aborted trace)")
    if report["chain_gaps"]:
        lines.append(f"!! {report['chain_gaps']} untraced hole(s) across "
                     f"request lifelines")
    t = report["ttfd"]
    lines.append(f"TTFD steps: p50 {t['p50_steps']:.1f}  "
                 f"p{q} {t[f'p{q}_steps']:.1f}  mean {t['mean_steps']:.1f}")
    lines.append(f"where the TTFD goes (fleet aggregate over admission "
                 f"prefixes):")
    for seg in critical.SEGMENTS:
        steps = report["ttfd_segments_steps"][seg]
        share = report["ttfd_segment_share"][seg]
        lines.append(f"  {seg:<12}{_fmt_steps(steps)} steps  "
                     f"{share * 100:5.1f}%")
    worst = report[f"p{q}_request"]
    if worst is not None:
        segs = ", ".join(f"{s}={v:.1f}" for s, v in
                         worst["segments_steps"].items() if v > 0)
        lines.append(f"p{q} request: rid {worst['rid']} "
                     f"ttfd {worst['ttfd_steps']:.1f} steps "
                     f"({segs}; {worst['preemptions']} preemption(s))")
    lines.append("what-if bounds:")
    for name, val in report["what_if"].items():
        lines.append(f"  {name:<28}{val:8.1f} steps")
    dev = report["device"]
    if dev["events"]:
        lines.append(f"device waits: {dev['events']} device_* event(s), "
                     f"{dev['spins']} flush spin(s)")
    overlay = report.get("measured_overlay")
    if overlay:
        lines.append("measured overlay (wall-clock seconds per segment):")
        for seg, row in overlay.items():
            lines.append(f"  {seg:<12}{row['wall_s'] * 1e3:10.3f} ms wall  "
                         f"{row['model_s'] * 1e3:10.3f} ms modeled  "
                         f"(n={row['n']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="critical-path / TTFD-attribution report over an "
                    "exported Chrome-trace document")
    ap.add_argument("trace", help="trace JSON written by --trace or a "
                                  "flight-recorder postmortem dump")
    ap.add_argument("--json", metavar="OUT.json", default=None,
                    help="also write the full report (with per-request "
                         "paths) as JSON")
    ap.add_argument("--q", type=int, default=99,
                    help="tail percentile for the report (default 99)")
    ap.add_argument("--calibration", metavar="SAMPLES.json", default=None,
                    help="profiler sample file (serve --profile output); "
                         "adds the measured-vs-modeled divergence report "
                         "and a per-segment measured overlay")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)
    warnings: list = []
    errors = export.validate(doc, warnings=warnings)
    events = export.events_from_doc(doc)
    chains = export._chains_from_events(events)
    samples = (prof_mod.load_samples(args.calibration)
               if args.calibration else None)
    report = critical.analyze(chains, events, q=float(args.q),
                              measured=samples)
    cal_report = (calibrate.report_from_samples(samples)
                  if samples is not None else None)

    if args.json:
        paths = critical.fleet_paths(chains, events)
        full = dict(report)
        full["validation_errors"] = errors
        full["validation_warnings"] = warnings
        if cal_report is not None:
            full["calibration"] = cal_report
        full["paths"] = {str(rid): p for rid, p in sorted(paths.items())}
        with open(args.json, "w") as f:
            json.dump(full, f, indent=1, sort_keys=True)
            f.write("\n")
    print(render(report, q=args.q, errors=errors, warnings=warnings))
    if cal_report is not None:
        print(calibrate.render(cal_report))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
