"""CPU tests of the deepseek_v2_lite configuration's benchmark pieces: its
``layers`` against the port's layer kinds, the model FLOP count of its two
kinds by hand, whole runs of its cell at a reduced size with the real
reference check (sound, under each planted fault, and the float8
control), its two readers, and the qwen3-4b weights as they were drawn
before it was added."""
import dataclasses
import hashlib
import json
import os
import types

import pytest
import torch

from perfbench import bench, check, faults, run, weights, yardstick
from perfbench.reference import common, mla_moe

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "deepseek_v2_lite.long_chat_backlog"
LIMIT = 1e-3      # float32 at this size: the program serves the argmax


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf():
    with open(os.path.join(HERE, "configs", "deepseek_v2_lite.json")) as f:
        return json.load(f)


def test_layers_are_the_ports_layer_kinds():
    from repro_torch.configs import base
    conf = _conf()
    assert conf["layers"] == [["mla", 1], ["mla_moe", 26]]
    cfg = bench.arch_config(conf["arch"])
    assert cfg == base.get_config("deepseek_v2_lite")
    assert base.layer_kinds(cfg) == ["mla"] + ["mla_moe"] * 26
    assert conf["reference"] == "mla_moe" and conf["reduced"] == []


def test_flop_count_by_hand():
    """d 2048, 16 heads: q 2048 x 16(128 + 64), kv_a 2048 x (512 + 64),
    kv_b 512 x 16(128 + 128), o 16 x 128 x 2048; the dense layer's SwiGLU
    of 10944; a MoE layer's 6 experts of 1408, the shared 2816 and the
    2048 x 64 router; 2 x 16 x (192 + 128) a visible position."""
    a = _conf()["arch"]
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    dense = 2 * (attn + 3 * 2048 * 10944)
    routed = 2 * (attn + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 2048 * 64)
    assert (attn, dense, routed) == (13_762_560, 162_004_992, 166_199_296)
    layers = _conf()["layers"]
    body, per_ctx, head = yardstick.flop_parts(a, layers)
    assert (body, per_ctx, head) == (dense + 26 * routed, 27 * 10240,
                                     2 * 2048 * 102400)
    assert yardstick.decode_flops(a, 3000, layers) == \
        dense + 26 * routed + 27 * 10240 * 3000 + 2 * 2048 * 102400


def _overrides():
    from repro_torch.configs import base
    conf = _conf()
    cfg = base.reduced(base.get_config("deepseek_v2_lite"))
    arch = dataclasses.asdict(cfg)
    arch["xlstm_pattern"] = list(arch["xlstm_pattern"])
    conf.update(arch=arch, layers=[["mla", 1], ["mla_moe", 2]])
    with open(os.path.join(HERE, "traffic", "long_chat_backlog.json")) as f:
        mix = json.load(f)
    mix["prompt"] = {"dist": "lognormal", "median": 24, "sigma": 0.25,
                     "min": 12, "max": 48}
    mix["output"] = {"dist": "uniform", "min": 4, "max": 12}
    mix["serving"].update(slots_per_pe=2, block_tokens=8)
    mix.update(check_tokens=24)
    return {"config": conf, "mix": mix, "limits": {"max_logit_gap": LIMIT}}


@pytest.fixture(autouse=True)
def _small_sample(monkeypatch):
    monkeypatch.setattr(check, "CHECK_MIN_TOKENS", 12)


def _run(seconds=2.0):
    args = types.SimpleNamespace(workload=CELL, seed=2**31 + 61,
                                 seconds=seconds, trace=0)
    return run.run_cell(args, device="cpu", overrides=_overrides(),
                        modules_check=False)


def test_a_sound_run_is_correct_against_the_reference():
    r = _run()
    assert r["correct"], r["check"]
    assert r["check"]["max_logit_gap"]["value"] <= LIMIT
    assert r["check"]["served_tokens_checked"]["value"] >= 12
    assert set(r["metrics"]) == {"output_tok_s", "tpot_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        r = _run()
    assert not r["correct"], r["check"]
    assert r["check"]["max_logit_gap"]["value"] > LIMIT


def test_the_float8_control_fails_the_limit():
    """On prompts and tokens the float32 reference serves greedily, the
    token the float8 reference puts first lies below the best by more
    than the limit the program meets."""
    from repro_torch.configs import base
    cfg = base.reduced(base.get_config("deepseek_v2_lite"))
    arch = dataclasses.asdict(cfg)
    seed = 2**31 + 5
    params = weights.make(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    samples = []
    for _ in range(4):
        prompt = torch.randint(0, cfg.vocab_size, (24,), generator=g)
        served = []
        for _ in range(12):
            seq = torch.cat([prompt, torch.tensor(served, dtype=torch.long)])
            served.append(int(mla_moe.logits(params, arch, seq, torch.tensor(
                [len(seq) - 1])).argmax()))
        samples.append((prompt.numpy(), served))
    prog, ctrl = check.served_gaps(mla_moe, params, arch, samples, "cpu",
                                   control=common.fp8_weight)
    judge = check.ServedCheck(None, {"max_logit_gap": LIMIT})
    assert bench.judge(judge.compare(prog))
    assert not bench.judge(judge.compare(ctrl))


class _Slice:
    def __init__(self, spans):
        self.spans = spans

    def range_device_s(self, name):
        return self.spans.get(name, 0.0)


@pytest.mark.parametrize("metric, name", [
    ("mla_decode_ms_per_tok", "decode.mla"),
    ("moe_decode_ms_per_tok", "decode.moe")])
def test_readers_divide_the_ranges_by_the_tokens(metric, name):
    r = bench.reader(metric)
    assert r.read({"slice": _Slice({name: 0.5}), "slice_tokens": 250}) == \
        pytest.approx(2.0)
    # a program with no such ranges (the parent's) gives no reading
    assert r.read({"slice": _Slice({}), "slice_tokens": 250}) is None
    assert r.read({"slice_tokens": 250}) is None


def _digest(params):
    h = hashlib.sha256()
    for path, leaf in weights._paths(params):
        h.update(repr(path).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("dtype, seed, want", [
    ("float32", 2**31 + 21, "71966b1af2d9aa14"),
    ("bfloat16", 3300000001, "f4d94f5ce24b8735")])
def test_qwen3_4b_weights_as_drawn_before(dtype, seed, want):
    """The reduced qwen3-4b tree, sha256 over each leaf's path and bytes,
    as the parent commit of the latent-attention configuration drew it."""
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.reduced(base.get_config("qwen3_4b")),
                              dtype=dtype, param_dtype=dtype)
    assert _digest(weights.make(cfg, seed, "cpu")) == want
