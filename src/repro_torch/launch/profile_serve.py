"""Where the disaggregated serving path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [serve flags] \
        [--layers N]

Takes the flags of ``repro_torch.launch.serve`` (``--disagg`` is implied)
and ``--layers N``, a depth cut of the architecture (``num_layers``, as
``chip_smoke.py`` cuts llama4-scout to 8 of 48 layers to fit the card).
It builds the weights once and serves four times in one process, each run
through ``serve._build_disagg`` (the weights' build is in no time below):

1. a warm-up run (kernel build, first-call setup);
2. a plain run, timed on the host clock: the wall time of the path;
3. **phases** — host wall time per scheduler phase (prefill, admit, decode)
   and inside ``SymmetricHeap.write`` (pool clone + K1 store), each
   bracketed by ``torch.cuda.synchronize`` so device work lands in the phase
   that issued it;
4. **kernels** — one run under ``torch.profiler``: device time of every
   device-side event (kernels, memcpy, memset), grouped into the port's
   kernels, matrix products, pool-clone copies, PyTorch's copy kernels and
   the rest.  Device busy share = that time over the plain run's wall
   (the profiler slows the host, not the device's kernels).

Prints ``[profile]`` lines and, as its last line, one JSON object with the
same numbers.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch

GROUPS = (("K1 copy_into", ("::copy_kernel<",)),
          ("K2 flash_attention", ("flash_fwd_kernel", "flash_fwd_wgmma")),
          ("K3 paged_gather", ("paged_gather_kernel",)),
          ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "splitk")),
          ("memcpy/memset (pool clones)", ("memcpy", "memset")),
          ("torch copy/cat", ("direct_copy_kernel", "catarray")))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k.lower() in name.lower() for k in keys):
            return group
    return "other"


class _PhaseClock:
    """Wraps scheduler phases and heap writes with synchronised timers."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def wrap(self, owner, name: str, label: str):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out
        setattr(owner, name, timed)
        return fn


def _server(argv):
    """(argv without ``--layers``, a function that serves it once and
    returns the finished scheduler), the weights built once."""
    import dataclasses

    from repro_torch import _devices
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import serve
    from repro_torch.models import model

    argv = list(argv)
    layers = None
    if "--layers" in argv:
        i = argv.index("--layers")
        layers = int(argv[i + 1])
        del argv[i:i + 2]
    args = serve.build_parser().parse_args(argv)
    cfg = cfgbase.get_config(args.arch)
    if not args.full:
        cfg = cfgbase.reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = model.init_params(cfg, seed=args.seed,
                               device=_devices.resolve(args.device))

    def run():
        sched = serve._build_disagg(args, cfg, params)
        sched.run()
        return sched
    return argv + ([] if layers is None else ["--layers", str(layers)]), run


def main(argv=None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.serve.scheduler import DisaggScheduler

    argv, serve_once = _server(
        ["--disagg"] + list(sys.argv[1:] if argv is None else argv))
    torch.backends.cuda.matmul.allow_tf32 = False
    serve_once()                                       # warm-up (and build)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_once()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    clock = _PhaseClock()
    originals = [(DisaggScheduler, n, clock.wrap(DisaggScheduler, n, n[1:]))
                 for n in ("_phase_prefill", "_phase_admit", "_phase_decode")]
    # heap stores nest inside the phases: reported beside them, not summed
    originals.append((SymmetricHeap, "write",
                      clock.wrap(SymmetricHeap, "write", "heap.write")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sched = serve_once()
        torch.cuda.synchronize()
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    phase_wall = time.perf_counter() - t0

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once()
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            kernels[evt.key][0] += evt.self_device_time_total / 1e3
            kernels[evt.key][1] += evt.count
    groups = defaultdict(float)
    for kname, (ms, _) in kernels.items():
        groups[_group(kname)] += ms
    busy_s = sum(groups.values()) / 1e3

    name = torch.cuda.get_device_name(0)
    print(f"[profile] {name}; serve {' '.join(argv)}")
    print(f"[profile] phases run (synchronised): {phase_wall:.3f} s wall "
          f"({sched.stats.decode_steps} decode steps)")
    for label in ("phase_prefill", "phase_admit", "phase_decode",
                  "heap.write"):
        print(f"[profile]   {label:14s} {clock.seconds[label]:8.3f} s over "
              f"{clock.calls[label]} calls")
    print(f"[profile] plain run: {wall:.3f} s wall; device busy {busy_s:.3f}"
          f" s ({100 * busy_s / wall:.1f}%), idle "
          f"{100 * (1 - busy_s / wall):.1f}%")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {group:28s} {ms:10.3f} ms")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for kname, (ms, n) in top:
        print(f"[profile]     {ms:10.3f} ms {n:6d}x  {kname[:90]}")
    result = {"device": name, "argv": argv, "wall_s": wall,
              "phase_wall_s": phase_wall, "phases_s": dict(clock.seconds),
              "phase_calls": dict(clock.calls), "device_busy_s": busy_s,
              "groups_ms": dict(groups),
              "top_kernels_ms": {k: v[0] for k, v in top}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
