"""Roofline over the dry-run records, with the H100's own peaks
(counterpart of ``repro/roofline/analysis.py``).

Per (arch x shape x mesh), from the record's ``counted_per_device`` (the
global counts of ``roofline/counter.py`` split evenly over the mesh's
chips) and its per-device ``memory``:

  compute    = flops per chip / peak FLOP/s (bf16 dense, or TF32 for an
               f32 configuration)
  memory     = the step's floor, each argument read once and each output
               written once (per-device shard bytes), / HBM bandwidth
  collective = on the card mesh, the collective kernels' wire bytes at HBM
               bandwidth (the simulated PEs are rows of one card's HBM); on
               the production meshes not modeled (the reference's GSPMD
               collectives have no counterpart in the port)

The counted ``bytes`` are the eager implementation's traffic (every aten
op's operands read and outputs written), which falls whenever ops fuse;
they are reported as ``eager_memory_s`` beside the bound and never set it.

plus MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference), the
useful-compute ratio MODEL_FLOPS / counted flops, and, for a measured run
of the same step, :func:`measured`'s bound share and MFU.

  PYTHONPATH=src python -m repro_torch.roofline.analysis experiments/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys

# H100 SXM at a 700 W limit, dense tensor cores (data sheet)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
PEAK_FLOPS_TF32 = 495e12     # TF32 FLOP/s per card (f32 configurations)
HBM_BW = 3.35e12             # B/s per card
MESHES = ("card", "pod1", "pod2")


def peak_flops(rec: dict) -> float:
    return PEAK_FLOPS_TF32 if rec.get("dtype") == "float32" else PEAK_FLOPS


def load(dirpath: str, mesh: str = "card"):
    return [json.load(open(p)) for p in
            sorted(glob.glob(os.path.join(dirpath, f"*.{mesh}.json")))]


def floor_bytes(rec: dict) -> int:
    """Per device: every argument read once and every output written once,
    the least HBM traffic of the step however its ops are fused."""
    mem = rec["memory"]
    return mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]


def terms(rec: dict) -> dict:
    c = rec["counted_per_device"]
    peak = peak_flops(rec)
    t_c = c["flops"] / peak
    t_m = floor_bytes(rec) / HBM_BW
    t_x = c["collective_bytes"] / HBM_BW if rec["mesh"] == "card" else None
    cands = [(t_c, "compute"), (t_m, "memory")]
    if t_x is not None:
        cands.append((t_x, "collective"))
    step, dom = max(cands)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "eager_memory_s": c["bytes"] / HBM_BW,
        "dominant": dom, "useful_ratio": rec["model_flops"]
        / max(1.0, rec["counted"]["flops"]),
        "step_s": step,
        "mfu_bound": (rec["model_flops"] / rec["chips"] / peak)
        / max(step, 1e-12),
    }


def measured(rec: dict, wall_s: float) -> dict:
    """A measured run of the record's step: the roofline's share of its
    wall (``bound_share``) and its MFU, MODEL_FLOPS over the wall at the
    chips' peak."""
    t = terms(rec)
    return {"wall_s": wall_s, "bound_s": t["step_s"],
            "bound_share": t["step_s"] / wall_s,
            "mfu": rec["model_flops"] / wall_s
            / (peak_flops(rec) * rec["chips"])}


def _fmt_s(x):
    if x is None:
        return "not modeled"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def table(dirpath: str, mesh: str = "card") -> str:
    rows = ["| arch | shape | status | compute | memory floor | collective "
            "| dominant | eager traffic | MODEL/counted flops | "
            "roofline-bound MFU |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for rec in load(dirpath, mesh):
        if rec.get("status") != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | "
                        f"{rec.get('status', '?')} | — | — | — | — | — | — "
                        "| — |")
            continue
        t = terms(rec)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | ok | "
            f"{_fmt_s(t['compute_s'])} | {_fmt_s(t['memory_s'])} | "
            f"{_fmt_s(t['collective_s'])} | **{t['dominant']}** | "
            f"{_fmt_s(t['eager_memory_s'])} | "
            f"{t['useful_ratio']:.2f} | {t['mfu_bound']:.1%} |")
    return "\n".join(rows)


def what_would_help(rec: dict) -> str:
    t = terms(rec)
    if t["dominant"] == "collective":
        return ("reduce wire bytes: fewer/larger fused collectives, "
                "reduce-scatter instead of all-reduce+slice, keep TP "
                "activations sharded between ops")
    if t["dominant"] == "memory":
        hint = ("shrink the bytes the step must touch: bf16 or 8-bit "
                "weights and optimizer state, more tokens per weight read, "
                "caches updated in place rather than returned whole")
    else:
        hint = ("raise tensor-core utilization: larger per-device matmul "
                "tiles, bf16 or TF32 operands for the f32 products, fewer "
                "low-arithmetic-intensity einsums")
    if t["eager_memory_s"] > t["step_s"]:
        hint += ("; the eager step's HBM traffic alone exceeds the bound: "
                 "fuse elementwise chains into the kernels around them, "
                 "bf16 intermediates")
    return hint


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    for mesh in MESHES:
        recs = load(d, mesh)
        if not recs:
            continue
        chips = {"card": 1, "pod1": 256, "pod2": 512}[mesh]
        print(f"\n### Roofline — {mesh} ({chips} H100"
              f"{'s' if chips > 1 else ''}: {PEAK_FLOPS / 1e12:.0f} TFLOP/s "
              f"bf16, {HBM_BW / 1e12:.2f} TB/s HBM each)\n")
        print(table(d, mesh))


if __name__ == "__main__":
    main()
