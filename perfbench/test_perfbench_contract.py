"""CPU tests that BENCHMARK.json and the files it names keep to the
benchmark's contract: names, units, keys, the readers of the metrics, the
cells' metrics, the configurations' files, the time budget, and that
nothing of the benchmark imports JAX or the JAX package."""
import ast
import json
import os
import re

import pytest

from perfbench import bench

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan)"
                   r"|_dim$|_rank$|experts_per_tok")


@pytest.fixture(scope="module")
def B():
    return bench.load_benchmark(ROOT)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(B):
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32 and all(_text(w)
                                                for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for w in B["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in B["paths"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_entry_keys(B):
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and \
            _text(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    seen |= set(names)
    assert "setup_s" in seen


def test_every_metric_has_a_reader_that_agrees(B):
    for m in B["end_to_end"] + B["per_layer"]:
        r = bench.reader(m["name"])
        assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"],
                                                m["source"])
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])


def test_every_cell_reports_what_the_contract_asks(B):
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for w in B["workloads"]:
        cell = bench.cell(B, w["name"], ROOT)
        got = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert bench.reports(e2e[m["moves"]], w["name"])
        assert "max_logit_gap" in cell["limits"] or cell["limits"]
    for m in B["per_layer"]:
        for w in m.get("workloads", []):
            assert bench.reports(e2e[m["moves"]], w)
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    n4 = sum(w["chips"] == 4 for w in B["workloads"])
    assert n4 <= max(1, len(B["workloads"]) // 4)


def test_configuration_files_run_as_the_program_takes_them(B):
    files = set()
    for c in B["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        cfg = bench.arch_config(conf["arch"])
        assert cfg.dtype == cfg.param_dtype == "bfloat16"


def test_run_seconds_fits_the_check_with_24_cells(B):
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in bench.FORBIDDEN, (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in ("torch", "perfbench",
                                             "importlib", "__future__",
                                             "math"), (f, mod)
