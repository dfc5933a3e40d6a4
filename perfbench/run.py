"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  Set-up (imports, weights drawn from the seed on the card, the
scheduler and its pool, the warm-up the mix asks for) counts from the
start of this process to the window's open; then the cell's runner
drives the program for ``--seconds``, and the check compares what the
window produced with the plain reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``, each compared number beside its limit, which also end
standard error.  Exits non-zero, printing no result, where there is no
card or too few, where the program is not in the checkout, or where JAX
or the JAX package is loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)         # run as a script: import perfbench.* by name
TRACE_SECONDS = 8.0       # the profiler starts this long before the close
                          # (or the mix's trace_seconds; at most half the
                          # window); its start takes 2-3 s
HOST_THREADS = "1"        # one process, few threads: a steadier host


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment() -> None:
    """Where the program's caches go, and no tuning from the caller's
    environment (the ``ISHMEM_*`` knobs ``context.init`` reads)."""
    for k in [k for k in os.environ if k.startswith("ISHMEM_")]:
        del os.environ[k]
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = HOST_THREADS
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def make_job(args, cell: dict, device, checker=None):
    """The namespace a runner runs: the run's arguments, the cell's
    configuration (its ``arch``, the program's ``ArchConfig`` of it, and
    the decoder ``layers`` the model FLOP count sums over), mix and
    reference, the set-up clock, and the check
    (``checker(job, limits)``, the cell's own where none is given)."""
    import torch

    from perfbench import bench as bench_mod, check as check_mod, reference

    conf = cell["config"]
    job = types.SimpleNamespace(
        workload=args.workload, seed=int(args.seed),
        seconds=float(args.seconds), trace=bool(args.trace),
        device=torch.device(device), arch=conf["arch"],
        layers=conf["layers"], cfg=bench_mod.arch_config(conf["arch"]),
        mix=cell["mix"],
        reference=reference.load(conf["reference"]), log=log,
        t_process=T_PROCESS, setup_s=None,
        trace_seconds=min(float(cell["mix"].get("trace_seconds",
                                                TRACE_SECONDS)),
                          0.5 * float(args.seconds)))
    job.checker = (checker or check_mod.ServedCheck)(job, cell["limits"])
    return job


def card(chips: int):
    """The first card, or exit where the machine has fewer than
    ``chips``."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < chips:
        raise SystemExit(f"the cell needs {chips} CUDA card(s); this "
                         f"machine has {n}")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def load_cell(name: str, overrides=None, bench=None) -> dict:
    from perfbench import bench as bench_mod
    bench = bench if bench is not None else bench_mod.load_benchmark(ROOT)
    cell = bench_mod.cell(bench, name, ROOT)
    cell.update(overrides or {})
    return cell


def run_cell(args, *, device=None, overrides=None, bench=None,
             modules_check=True, checker=None) -> dict:
    """One run of ``args.workload``; returns the result object.  Tests
    pass ``device`` (skipping the look for a card), ``overrides`` of the
    cell's pieces (``config``, ``mix``, ``limits``) and, in a test
    process that other tests share, no look at ``sys.modules``;
    ``perfbench/control.py`` passes its ``checker``."""
    import torch

    from perfbench import bench as bench_mod, runners

    cell = load_cell(args.workload, overrides, bench)
    chips = int(cell["workload"]["chips"])
    if device is None:
        device = card(chips)
    torch.set_num_threads(int(HOST_THREADS))
    job = make_job(args, cell, device, checker)
    device = job.device
    obs = runners.load(job.mix["runner"]).run(job)

    found = bench_mod.forbidden_modules(list(sys.modules)) \
        if modules_check else []
    if found:
        raise SystemExit(f"loaded once the window closed: {found}")

    wanted = cell["per_layer"] if job.trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = bench_mod.reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(obs["memory_peak_bytes"]),
           "power": _power_limit() if device.type == "cuda" else "none"}
    result = {"correct": bench_mod.judge(obs["check"]),
              "attempted": int(obs["attempted"]),
              "failed": int(obs["failed"]), "metrics": metrics,
              "device": dev}
    sl = obs.get("slice")
    if job.trace and sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.wall_s
        result["breakdown"] = {"device_ops": sl.groups()[:10],
                               "idle_gaps": sl.idle_gaps()[:10]}
    result["check"] = obs["check"]
    return result


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        log("the program (src/repro_torch) is not in this checkout")
        return 2
    _environment()
    result = run_cell(args)
    for name, entry in result["check"].items():
        sense = ">=" if entry.get("at_least") else "<="
        print(f"check {name} {entry['value']} {sense} limit "
              f"{entry['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
