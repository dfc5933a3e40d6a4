"""Finding the pieces of a cell by name: ``BENCHMARK.json`` at the root of
the checkout, the configuration file it names, the traffic mix at
``perfbench/traffic/<mix>.json``, the limits of the cell's check at
``perfbench/limits/<cell>.json``, one reader a metric at
``perfbench/metrics/<metric>.py``, and the model FLOP formulas of each
layer kind the configuration's ``layers`` name at
``perfbench/work/<kind>.py``.  Adding a cell, a mix, a configuration or a
metric adds files and entries; no file here changes.  A configuration of
another family adds its file (its ``arch``, the ``layers`` of its decoder
and the ``reference`` module it names under ``perfbench/reference/``), a
mix, the cell's limits, and a formula file for a layer kind that has
none yet."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """Everything one cell needs: its entry, configuration, mix, limits
    and the metrics it reports with ``--trace 0`` and ``--trace 1``."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits_path = os.path.join(HERE, "limits", f"{name}.json")
    return {
        "workload": w,
        "config": _json(root, conf["file"]),
        "mix": _json(HERE, "traffic", f"{w['traffic']}.json"),
        "limits": (_json(limits_path) if os.path.exists(limits_path)
                   else {}),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in bench["per_layer"]
                      if _per_layer_reports(bench, m, name)],
    }


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _per_layer_reports(bench: dict, metric: dict, workload: str) -> bool:
    """A per-layer metric with ``workloads`` is read in those cells; one
    without, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
    return reports(moves, workload)


def reader(name: str):
    """The reader module of metric ``name``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arch_config(arch: dict):
    """The program's ``ArchConfig`` for a configuration file's ``arch``."""
    from repro_torch.configs.base import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = set(arch) - names
    if unknown:
        raise KeyError(f"not ArchConfig fields: {sorted(unknown)}")
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in arch.items()})


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX,
    jaxlib, flax or the JAX package, compared whole: ``repro_torch``
    passes."""
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


def judge(check: dict) -> bool:
    """Every compared number within its limit; a number with no limit,
    or no finite value, fails."""
    for entry in check.values():
        v, lim = entry["value"], entry["limit"]
        if lim is None or v is None or v != v or v in (float("inf"),
                                                       float("-inf")):
            return False
        if (v < lim) if entry.get("at_least") else (v > lim):
            return False
    return True
