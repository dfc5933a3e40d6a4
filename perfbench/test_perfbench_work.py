"""CPU tests of the model FLOP count by layer kind: each kind's formulas
by hand at a tiny ``arch``, the sliding window's visible context, the
missing kind's error, the configuration files' ``layers`` against the
program's ``layer_kinds``, and the qwen3-4b counts as they were before
the count went by kind."""
import ast
import dataclasses
import glob
import json
import os

import pytest

from perfbench import bench, work, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))

TINY = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "mlp_type": "swiglu",
        "vocab_size": 10, "attention": "full", "window": 4,
        "num_experts": 6, "experts_per_token": 2, "moe_dense_ff": 12,
        "ssm_state": 3, "ssm_expand": 2, "ssm_conv": 4}
# d 8, 2 query heads and 1 K/V head of 4: q 8x8, k and v 8x4, o 8x8
ATTN = 8 * 8 + 2 * 8 * 4 + 8 * 8
CTX = 4 * 2 * 4                   # QK^T and PV, 2 heads of 4


def expand(layers):
    """[[kind, count], ...] -> one kind a layer."""
    return [kind for kind, n in layers for _ in range(n)]


def runs(kinds):
    """[kind, ...] -> run-length [[kind, count], ...]."""
    out = []
    for k in kinds:
        if out and out[-1][0] == k:
            out[-1][1] += 1
        else:
            out.append([k, 1])
    return out


@pytest.mark.parametrize("kind, token, ctx", [
    ("attn", 2 * (ATTN + 3 * 8 * 16), CTX),
    ("shared_attn", 2 * (ATTN + 3 * 8 * 16), CTX),
    # the router 8x6, the 2 routed experts of width 16 and the dense MLP
    # of width 12; the other 4 experts do not count
    ("moe", 2 * (ATTN + 2 * 3 * 8 * 16 + 3 * 8 * 12 + 8 * 6), CTX),
    # d_in 16 in 1 head of 16 (16 % 64 != 0: the largest of 32, 16, 8
    # that divides it), N 3, K 4: wz, wx 8x16, wB, wC 8x3, wdt 8x1,
    # out_proj 16x8; the conv over 16 + 6 channels; the state of 16 x 3
    # words updated and read
    ("mamba", 2 * (2 * 8 * 16 + 2 * 8 * 3 + 8 * 1 + 16 * 8)
     + 2 * 4 * (16 + 6) + 4 * 16 * 3, 0),
    # d_in 16 in 2 heads of dk 8: wx, wz 8x16, wq, wk, wv 16x16, wi, wf
    # 16x2, out_proj 16x8; C of 2 x 8 x 8 and n of 16 words
    ("mlstm", 2 * (2 * 8 * 16 + 3 * 16 * 16 + 2 * 16 * 2 + 16 * 8)
     + 4 * (16 * 8 + 16), 0),
    # w_in 8x32, r 4 x 2 heads of 4x4, ffp = 4*8/3 -> 11 -> 16: ff1 8x32,
    # ff2 16x8
    ("slstm", 2 * (8 * 32 + 4 * 2 * 4 * 4 + 8 * 32 + 16 * 8), 0),
])
def test_each_kind_counts_its_shapes_by_hand(kind, token, ctx):
    f = work.formula(kind)
    assert f.token_flops(TINY) == token
    assert f.context_flops(TINY) == ctx
    # the sum over a layer list of this kind alone
    head = 2 * 8 * 10
    assert yardstick.decode_flops(TINY, 3, [[kind, 2]]) == \
        2 * token + 2 * ctx * 3 + head


def test_moe_counts_the_active_experts_whatever_the_capacity():
    more = dict(TINY, num_experts=60, capacity_factor=4.0)
    f = work.formula("moe")
    assert f.token_flops(more) - f.token_flops(TINY) == 2 * 8 * (60 - 6)
    top1 = dict(TINY, experts_per_token=1)
    assert f.token_flops(TINY) - f.token_flops(top1) == 2 * 3 * 8 * 16


def test_a_layer_list_sums_its_kinds_in_any_order():
    layers = [["mamba", 2], ["shared_attn", 1], ["mamba", 2],
              ["shared_attn", 1]]
    m, s = work.formula("mamba"), work.formula("shared_attn")
    body, per_ctx, head = yardstick.flop_parts(TINY, layers)
    assert body == 4 * m.token_flops(TINY) + 2 * s.token_flops(TINY)
    assert per_ctx == 2 * CTX and head == 2 * 8 * 10
    assert expand(layers) == ["mamba"] * 2 + ["shared_attn"] + \
        ["mamba"] * 2 + ["shared_attn"]
    assert yardstick.prefill_flops(TINY, 5, layers) == \
        5 * body + per_ctx * 15 + head


def test_a_sliding_window_counts_the_visible_context_only():
    swa = dict(TINY, attention="swa", window=4)
    body, per_ctx, head = yardstick.flop_parts(swa)
    # a query at context c sees min(c, 4) positions
    assert yardstick.decode_flops(swa, 3) == body + per_ctx * 3 + head
    assert yardstick.decode_flops(swa, 9) == body + per_ctx * 4 + head
    # prefill of 6: positions see 1, 2, 3, 4, 4, 4
    assert yardstick.visible_prefix_sum(swa, 6) == 18
    assert yardstick.prefill_flops(swa, 6) == 6 * body + per_ctx * 18 + head
    assert yardstick.prefill_flops(swa, 4) == \
        yardstick.prefill_flops(TINY, 4)
    assert yardstick.train_flops(swa, 6, 2) == \
        3 * 2 * (6 * (body + head) + per_ctx * 18)
    # full attention sees the whole context however long
    assert yardstick.decode_flops(TINY, 9) == body + per_ctx * 9 + head


def test_a_kind_with_no_file_raises_naming_the_file():
    with pytest.raises(ValueError, match=r"perfbench/work/encdec\.py"):
        yardstick.prefill_flops(TINY, 4, [["attn", 1], ["encdec", 1]])
    with pytest.raises(ValueError, match="states its decoder layers"):
        yardstick.decode_flops(dict(TINY, family="hybrid"), 4)


# the parent's counts (the dense formula, before the count went by kind)
QWEN3_PREFILL = {512: 3798753738752.0, 1536: 11858561859584.0,
                 3072: 25107915210752.0}
QWEN3_DECODE_600 = 8398438400.0


@pytest.mark.parametrize("with_layers", [True, False])
def test_qwen3_4b_counts_equal_the_dense_formula(with_layers):
    with open(os.path.join(HERE, "configs", "qwen3_4b.json")) as f:
        conf = json.load(f)
    layers = conf["layers"] if with_layers else None
    for S, want in QWEN3_PREFILL.items():
        assert yardstick.prefill_flops(conf["arch"], S, layers) == \
            pytest.approx(want, rel=1e-12, abs=0)
    assert yardstick.decode_flops(conf["arch"], 600, layers) == \
        pytest.approx(QWEN3_DECODE_600, rel=1e-12, abs=0)


def _config_files():
    return sorted(glob.glob(os.path.join(HERE, "configs", "*.json")))


@pytest.mark.parametrize("path", _config_files(),
                         ids=lambda p: os.path.basename(p))
def test_every_configuration_file_states_the_programs_layers(path):
    from repro_torch.configs import base
    with open(path) as f:
        conf = json.load(f)
    layers = conf["layers"]
    assert all(isinstance(k, str) and isinstance(n, int) and n > 0
               for k, n in layers)
    assert expand(layers) == \
        base.layer_kinds(bench.arch_config(conf["arch"]))
    for kind, _ in layers:
        work.formula(kind)


@pytest.mark.parametrize("name", ["qwen3_4b", "zamba2_2_7b", "arctic_480b",
                                  "xlstm_125m", "h2o_danube_3_4b",
                                  "minitron_8b", "starcoder2_7b",
                                  "llama4_scout_17b_a16e"])
def test_every_served_family_of_the_port_has_a_count(name):
    """Each configuration the port serves with no frontend, at its
    registered size, counts more FLOPs for a longer prompt and context."""
    from repro_torch.configs import base
    cfg = base.get_config(name)
    a = dataclasses.asdict(cfg)
    layers = runs(base.layer_kinds(cfg))
    assert yardstick.prefill_flops(a, 64, layers) > 0
    assert yardstick.decode_flops(a, 600, layers) >= \
        yardstick.decode_flops(a, 300, layers) > 0


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_kind_files_import_nothing_of_the_program():
    files = glob.glob(os.path.join(HERE, "work", "*.py"))
    kinds = {os.path.basename(f)[:-3] for f in files}
    assert {"attn", "shared_attn", "moe", "mamba", "mlstm",
            "slstm"} <= kinds
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] in ("perfbench", "importlib",
                                         "__future__"), (f, mod)
