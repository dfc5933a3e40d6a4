"""The readings a cell's limit is set from, on the card, at the cell's own
size, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 15 [--faults token_altered,state_unchanged] [--out f.json]

Each seed is one run of the cell as a benchmark run makes it (weights,
traffic, set-up, a window of ``--seconds``, the check).  Its check gives
the lower reading: the program's widest logit gap.  Beside it, on the
same sample, the control is read: the reference put in the program's
place with float8 weights, the precision below the configuration's
bfloat16, giving the gap of the token the lower precision puts first.
That control check is judged by the cell's limits, as the program's is.
Then each fault of ``--faults`` (``perfbench/faults.py``) is planted for
one more run, on the seeds in turn, and that run's own check is judged.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from perfbench import bench, check, faults, run  # noqa: E402
from perfbench.reference import common  # noqa: E402


def _gap(chk: dict):
    return chk["max_logit_gap"]["value"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    run._environment()
    import torch

    cell = run.load_cell(a.workload)
    dev = run.card(int(cell["workload"]["chips"]))
    seeds = [int(s) for s in a.seeds.split(",")]
    made = []

    def checker(job, limits):
        made.append(check.ServedCheck(job, limits, control=common.fp8_weight))
        return made[-1]

    def one(seed, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        args = types.SimpleNamespace(workload=a.workload, seed=seed,
                                     seconds=a.seconds, trace=0)
        r = run.run_cell(args, device=dev, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        return r

    rows = []
    for seed in seeds:
        r = one(seed, checker=checker)
        ctl = made[-1].control_check
        rows.append({"seed": seed, "program": r["check"],
                     "program_correct": r["correct"], "control": ctl,
                     "control_correct": bench.judge(ctl),
                     "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
        run.log(f"control: {json.dumps(rows[-1])}")
    for i, name in enumerate(f for f in a.faults.split(",") if f):
        seed = seeds[i % len(seeds)]
        try:
            with faults.planted(name):
                r = one(seed)
        except Exception as e:     # a crash gives no number: not correct
            r = {"check": {"error": repr(e)[:300]}, "correct": False}
        rows.append({"seed": seed, "fault": name, "program": r["check"],
                     "program_correct": r["correct"]})
        run.log(f"fault: {json.dumps(rows[-1])}")
    sound = [r for r in rows if "fault" not in r]
    summary = {
        "workload": a.workload, "card": run._power_limit(),
        "seconds": a.seconds, "rows": rows,
        "lower": max(_gap(r["program"]) for r in sound),
        "upper": min(_gap(r["control"]) for r in sound),
        "faults": {r["fault"]: [r["program"].get("max_logit_gap"),
                                r["program_correct"]]
                   for r in rows if "fault" in r}}
    text = json.dumps(summary)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
