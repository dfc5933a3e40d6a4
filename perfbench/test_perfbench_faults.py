"""A whole run of a serving cell on the CPU at a reduced size, skipping
the look for a card: a sound run is correct, and with the timed path
broken underneath the check comes out false, once for each fault the
cell can have.  Also the control: the reference in float8 fails the
limit that the sound run meets."""
import dataclasses
import json
import os
import types

import pytest
import torch

from perfbench import bench, check, faults, run, weights
from perfbench.reference import common

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 1e-3      # float32 at this size: the program serves the argmax


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(name, mix_name):
    from repro_torch.configs import base
    arch = dataclasses.asdict(base.reduced(base.get_config(name)))
    arch["xlstm_pattern"] = list(arch["xlstm_pattern"])
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf["arch"] = arch
    with open(os.path.join(HERE, "traffic", f"{mix_name}.json")) as f:
        mix = json.load(f)
    mix["prompt"] = {"dist": "lognormal", "median": 24, "sigma": 0.35,
                     "min": 12, "max": 48}
    mix["output"] = {"dist": "uniform", "min": 4, "max": 12}
    mix["serving"].update(slots_per_pe=2, block_tokens=8)
    mix.update(check_tokens=24)
    if "rate" in mix:
        mix["rate"] = 8.0
    return {"config": conf, "mix": mix,
            "limits": {"max_logit_gap": LIMIT}}


@pytest.fixture(autouse=True)
def _small_sample(monkeypatch):
    monkeypatch.setattr(check, "CHECK_MIN_TOKENS", 12)


def _run(name="qwen3_4b", mix="decode_backlog", seconds=2.0):
    args = types.SimpleNamespace(workload=f"{name}.{mix}", seed=2**31 + 21,
                                 seconds=seconds, trace=0)
    return run.run_cell(args, device="cpu", overrides=_overrides(name, mix),
                        modules_check=False)


@pytest.mark.parametrize("mix, metric", [("decode_backlog", "output_tok_s"),
                                         ("long_prompt", "ttft_p50_ms")])
def test_a_sound_run_is_correct(mix, metric):
    r = _run(mix=mix)
    assert r["correct"], r["check"]
    assert r["check"]["max_logit_gap"]["value"] <= LIMIT
    assert r["metrics"][metric]["value"] > 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        r = _run()
    assert not r["correct"], r["check"]
    assert r["check"]["max_logit_gap"]["value"] > LIMIT


@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6])
def test_the_float8_control_fails_the_limit(seed):
    """The control at a size a test run holds: on the same prompts and
    served tokens, the token the float8 reference puts first lies below
    the float32 reference's best by more than the limit the program
    meets, and the check judges it so."""
    from perfbench.reference import dense
    from repro_torch.configs import base
    cfg = base.reduced(base.get_config("qwen3_4b"))
    arch = dataclasses.asdict(cfg)
    params = weights.make(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    samples = []
    for _ in range(4):
        prompt = torch.randint(0, cfg.vocab_size, (24,), generator=g)
        toks = dense.logits(params, arch, prompt, torch.tensor([23]))
        served = [int(toks.argmax())]
        for _ in range(11):           # greedy under the reference itself
            seq = torch.cat([prompt, torch.tensor(served)])
            served.append(int(dense.logits(params, arch, seq,
                                           torch.tensor([len(seq) - 1]))
                              .argmax()))
        samples.append((prompt.numpy(), served))
    prog, ctrl = check.served_gaps(dense, params, arch, samples, "cpu",
                                   control=common.fp8_weight)
    judge = check.ServedCheck(None, {"max_logit_gap": LIMIT})
    assert bench.judge(judge.compare(prog))
    assert not bench.judge(judge.compare(ctrl))
