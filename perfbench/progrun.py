"""Run one cell traced with the port's own wall-clock span tracer attached,
and read the program's spans beside the profiler's slice.

    python3 perfbench/progrun.py --workload <cell> --seed <n> \
        --seconds <s> [--program-tracer 0|1] [--program-trace OUT.json]

A ``--trace 1`` run of ``perfbench/run.py`` whose scheduler, once built,
carries ``SpanTracer(clock=WallClock())`` on its context (with
``--program-tracer 0`` none, the control for the tracer's cost).  The last
line of standard output is the run's result object with ``program``
added: the cell's end-to-end metrics read from the traced run's
observation, the readings of ``perfbench/progtrace.py``, the clock check
(the gaps between ``decode.model`` and the ``perfbench.decode_step``
range around the same call), the slice's idle time by innermost program
span, the median duration of each span and request phase, and the
tracer's events per scheduler step in the window.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT      # run as a script: import perfbench.* by name

import argparse  # noqa: E402
import json  # noqa: E402

from perfbench import run as run_mod  # noqa: E402

READINGS = ("decode_model_idle_ms", "heap_write_amp", "kv_stage_ms",
            "kv_wire_ms", "req_queued_ms")


def traced_cell(args, attach: bool = True, trace_out=None,
                **run_cell_kw) -> dict:
    """One ``--trace 1`` run of ``args.workload`` through
    ``run.run_cell`` (which takes ``run_cell_kw``), the program tracer
    attached after the runner's ``build``; returns the result with
    ``program``, and writes the program's Chrome trace (the profiler's
    trace start and the window in its ``otherData``) to ``trace_out``."""
    from perfbench import bench, progtrace
    from perfbench.runners import serve as runner
    from repro_torch.obs import export
    from repro_torch.obs.tracer import SpanTracer, WallClock

    seen = {}
    build, observe, observe_trace, run = (runner.build, runner._observe,
                                          runner._observe_trace, runner.run)

    def build_traced(*a, **kw):
        out = build(*a, **kw)
        if attach:
            seen["tracer"] = out[0].ctx.tracer = SpanTracer(
                clock=WallClock())
        return out

    def observe_window(job, srv, warm, t_open, t_close):
        seen["window"] = (t_open, t_close)
        return observe(job, srv, warm, t_open, t_close)

    def observe_slice(probes, prof, *a):
        if prof is not None:
            seen["trace_start_ns"] = \
                prof.profiler.kineto_results.trace_start_ns()
        return observe_trace(probes, prof, *a)

    def run_kept(job):
        seen["obs"] = run(job)
        return seen["obs"]

    runner.build, runner._observe = build_traced, observe_window
    runner._observe_trace, runner.run = observe_slice, run_kept
    try:
        result = run_mod.run_cell(args, **run_cell_kw)
    finally:
        runner.build, runner._observe = build, observe
        runner._observe_trace, runner.run = observe_trace, run
    obs = seen["obs"]
    cell = run_mod.load_cell(args.workload, run_cell_kw.get("overrides"),
                             run_cell_kw.get("bench"))
    prog = {m["name"]: bench.reader(m["name"]).read(obs)
            for m in cell["end_to_end"]}
    tracer = seen.get("tracer")
    if tracer is not None and "trace_start_ns" in seen:
        lo, hi = (tracer.clock.at_ns(round(t * 1e9))
                  for t in seen["window"])
        obs["program_trace"] = {"events": tracer.events,
                                "trace_start_ns": seen["trace_start_ns"],
                                "window_us": (lo, hi)}
        for name in READINGS:
            prog[name] = getattr(progtrace, name)(obs)
        prog["clock_gaps_ms"] = progtrace.clock_gaps_ms(obs)
        prog["idle_by_span"] = progtrace.idle_by_span(obs)
        prog["span_medians_ms"] = progtrace.span_medians_ms(obs)
        inside = [ev for ev in tracer.events if lo <= ev.ts <= hi]
        steps = {ev.step for ev in inside}
        prog["events_per_step"] = len(inside) / max(1, len(steps))
        prog["events"] = len(tracer.events)
        prog["dropped"] = tracer.dropped
        if trace_out:
            doc = export.chrome_trace_events(
                tracer.events, dropped=tracer.dropped, clock="wall",
                other={"trace_start_ns": seen["trace_start_ns"],
                       "window_us": [lo, hi]})
            with open(trace_out, "w") as f:
                json.dump(doc, f)
    result["program"] = prog
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--program-trace", metavar="OUT.json", default=None,
                   help="write the program's wall-clock Chrome trace")
    a = p.parse_args(argv)
    run_mod._environment()
    args = run_mod.parse(["--workload", a.workload, "--seed", str(a.seed),
                          "--seconds", str(a.seconds), "--trace", "1"])
    result = traced_cell(args, attach=bool(a.program_tracer),
                         trace_out=a.program_trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
