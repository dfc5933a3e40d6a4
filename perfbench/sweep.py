"""The sweep that finds an open-loop cell's knee, once, on the card.

    python3 perfbench/sweep.py --workload <cell> --rates 0.3,0.5,0.7 \
        --seconds 30 --seed 7 [--out sweep.json]

Runs the cell's mix at each offered rate (requests a second) in one
process and reports, per rate, the median and the 90th percentile of the
time to first token over the requests due in the window, the same over
its first and second halves, and how many requests were still waiting at
the close.  A rate the system sustains keeps the second half's times
near the first's; past the knee the queue grows all through the window.
The mix file then fixes the cell's rate; the benchmark's runs never
sweep.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from perfbench import run, stats  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    run._environment()
    import gc

    import torch

    from perfbench import runners
    base = run.load_cell(a.workload)
    dev = run.card(int(base["workload"]["chips"]))
    rows = []
    for rate in (float(r) for r in a.rates.split(",")):
        cell = copy.deepcopy(base)
        cell["mix"]["rate"] = rate
        args = argparse.Namespace(workload=a.workload, seed=a.seed,
                                  seconds=a.seconds, trace=0)
        job = run.make_job(args, cell, dev)
        job.t_process = time.perf_counter()
        job.checker = lambda params, finished: {}
        obs = runners.load(job.mix["runner"]).run(job)
        t = obs["ttfts"]
        half = len(t) // 2
        row = {"rate": rate, "due": len(t), "waiting_at_close":
               obs["waiting_at_close"]}
        for key, part in (("all", t), ("first_half", t[:half]),
                          ("second_half", t[half:])):
            if part:
                row[key] = {"p50_ms": 1e3 * stats.percentile(part, 50),
                            "p90_ms": 1e3 * stats.percentile(part, 90)}
        rows.append(row)
        job.log(f"sweep: {json.dumps(row)}")
        del obs, job
        gc.collect()
        torch.cuda.empty_cache()
    text = json.dumps({"workload": a.workload, "card": run._power_limit(),
                       "rows": rows})
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
