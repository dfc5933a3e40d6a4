"""Whole runs on the CPU, skipping the look for a card, of families other
than the dense one: the reduced hybrid (Mamba2 and a shared attention
block), MoE, recurrent (mLSTM and sLSTM) and sliding-window
configurations of the port, served through ``run.run_cell`` as a cell is,
with a stub in place of the check (the benchmark has no reference for
them yet).  Each finishes requests, reports its tokens per second, and
counts the window's model FLOPs by its own layer kinds.  These are test
overrides of a cell's pieces, not benchmark configurations."""
import dataclasses
import types

import pytest
import torch

from perfbench import run, yardstick
from perfbench.runners import serve
from perfbench.test_perfbench_faults import _overrides
from perfbench.test_perfbench_work import runs


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_checker(job, limits):
    return lambda params, finished: {
        "finished": {"value": len(finished), "limit": 1, "at_least": True}}


@pytest.mark.parametrize("name", ["zamba2_2_7b", "arctic_480b",
                                  "xlstm_125m", "h2o_danube_3_4b"])
def test_a_family_runs_through_the_harness(name, monkeypatch):
    from repro_torch.configs import base
    over = _overrides("qwen3_4b", "decode_backlog")
    cfg = base.reduced(base.get_config(name))
    arch = dataclasses.asdict(cfg)
    arch["xlstm_pattern"] = list(arch["xlstm_pattern"])
    layers = runs(base.layer_kinds(cfg))
    over["config"] = dict(over["config"], arch=arch, layers=layers)
    seen = {}
    observe = serve._observe

    def spy(job, *a):
        seen["obs"] = observe(job, *a)
        seen["layers"] = job.layers
        return seen["obs"]

    monkeypatch.setattr(serve, "_observe", spy)
    args = types.SimpleNamespace(workload="qwen3_4b.decode_backlog",
                                 seed=2**31 + 33, seconds=2.0, trace=0)
    r = run.run_cell(args, device="cpu", overrides=over, modules_check=False,
                     checker=_stub_checker)
    assert r["correct"], r["check"]
    assert r["check"]["finished"]["value"] >= 1
    assert r["metrics"]["output_tok_s"]["value"] > 0
    obs = seen["obs"]
    assert seen["layers"] == layers
    assert obs["model_flops"] > 0
    # every token of the window at least passed through the layers once
    body, _, head = yardstick.flop_parts(arch, layers)
    assert obs["model_flops"] >= obs["tokens"] * (body + head)
