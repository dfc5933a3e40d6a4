"""What the host proxy costs a put, and where a fleet run's memory peaks.

    PYTHONPATH=src python -m repro_torch.launch.profile_fleet [fleet argv]

1. The proxy: ``--puts`` stores of one KV block of the fleet's pool into a
   decode PE's row, once through ``heap.write`` directly and once through a
   :class:`~repro_torch.core.proxy.HostProxy` (a ring message, then a
   drain: the route a cross-pod flush takes), each timed over the whole
   loop with the device synchronised; prints ms a put for both and their
   difference, the proxy's own cost.
2. The fleet: runs the argv's fleet (``serve.build_fleet``) with every
   scheduler phase wrapped to read the peak of allocated device memory
   during it; prints the wall, the overall peak and the phases with the
   largest peaks (fleet step, pod, phase).

Runs on the current CUDA device unless ``--device`` says otherwise (on the
CPU the memory readings are 0).  The fleet argv defaults to
``chip_smoke.py``'s phase 23.
"""
from __future__ import annotations

import argparse
import time

import torch

PHASES = ("_phase_recover", "_phase_prefill", "_phase_admit",
          "_phase_resume", "_phase_decode")
FLEET_ARGV = ["--fleet", "--full", "--arch", "qwen3-4b", "--pods", "2",
              "--pod-prefill", "1", "--pod-decode", "2", "--slots", "2",
              "--kv-blocks", "256", "--block-tokens", "16", "--prompt-len",
              "512", "--max-new", "16", "--admission", "slo", "--router",
              "affinity", "--rate", "1.2", "--fleet-steps", "16",
              "--stream-chunks", "0", "--seed", "1"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def proxy_cost(fleet, puts: int) -> dict:
    """ms a put, direct and through the proxy, for one KV block of the
    fleet's pool stored into its last PE's row ``puts`` times."""
    from repro_torch.core.proxy import HostProxy
    heap, pool = fleet.heap, fleet.pool
    dev = heap.device
    pe = fleet.fcfg.npes - 1
    ptr = pool.block_ptr(0)
    payload = heap.read(pool.block_ptr(1), 0).clone()
    px = HostProxy(fleet.ctx)
    out = {}
    for route in ("direct", "proxy", "direct", "proxy"):
        h = heap
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(puts):
            if route == "direct":
                h = h.write(ptr, pe, payload)
            else:
                px.put(ptr, payload, pe)
                h = px.drain(h)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / puts
        out[route] = min(ms, out.get(route, ms))   # the better of two runs
        del h
    out["proxy_extra"] = out["proxy"] - out["direct"]
    out["block_bytes"] = ptr.nbytes
    return out


def main(argv=None) -> dict:
    from repro_torch.launch import serve
    ap = argparse.ArgumentParser()
    ap.add_argument("--puts", type=int, default=64)
    args, rest = ap.parse_known_args(argv)
    fleet, specs, fargs = serve.build_fleet(rest or FLEET_ARGV)
    dev = fleet.heap.device
    cost = proxy_cost(fleet, args.puts)
    print(f"[profile_fleet] one block ({cost['block_bytes']} B) a put: "
          f"direct {cost['direct']:.4f} ms, through the proxy "
          f"{cost['proxy']:.4f} ms, the proxy's own "
          f"{cost['proxy_extra']:.4f} ms")
    peaks = []
    on_card = dev.type == "cuda"
    for pod in fleet.pods:
        sched = pod.sched
        for name in PHASES:
            fn = getattr(sched, name)

            def wrapped(fn=fn, name=name, pod=pod):
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                fn()
                if on_card:
                    peaks.append((torch.cuda.max_memory_allocated(dev)
                                  / 2**30, fleet.elapsed_steps, pod.name,
                                  name.removeprefix("_phase_")))
            setattr(sched, name, wrapped)
    base = torch.cuda.memory_allocated(dev) / 2**30 if on_card else 0.0
    _sync(dev)
    t0 = time.perf_counter()
    rep = fleet.run(specs)
    _sync(dev)
    wall = time.perf_counter() - t0
    peaks.sort(reverse=True)
    print(f"[profile_fleet] fleet: {wall:.2f} s wall, {rep['completed']} "
          f"of {rep['offered']} completed in {fleet.elapsed_steps} steps; "
          f"{base:.2f} GiB allocated before the run")
    for gib, step, pod, phase in peaks[:6]:
        print(f"[profile_fleet]   peak {gib:.2f} GiB in step {step}, "
              f"{pod}, {phase}")
    return {"proxy": cost, "wall_s": wall, "base_gib": base,
            "peaks": peaks[:6]}


if __name__ == "__main__":
    main()
