"""CPU tests of the benchmark's weight rules: a stated rule for every leaf
of every configuration the port holds, the stacking axis never a fan-in,
and the qwen3-4b tree bitwise what the dense rule drew before the rules
covered every leaf."""
import dataclasses
import hashlib
import math

import pytest
import torch

from perfbench import weights

ALL = ["qwen3_4b", "zamba2_2_7b", "xlstm_125m", "arctic_480b",
       "h2o_danube_3_4b", "minitron_8b", "starcoder2_7b",
       "llama4_scout_17b_a16e", "whisper_medium", "llama_3_2_vision_90b"]


def _parent_make(cfg, seed, device):
    """The rule as it stood when only dense trees were drawn: norms one,
    every other leaf a matrix at fan_in^-0.5 (the embedding at 0.02), one
    randn a dtype in tree order."""
    from repro_torch.models import model
    meta = model.init_params(cfg, device="meta")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ones = ("norm1", "norm2", "final_norm", "q_norm", "k_norm")
    mats, params = {}, weights._empty_like_tree(meta)
    for path, m in weights._paths(meta):
        if path[-1] in ones:
            weights._set(params, path, torch.ones(m.shape, dtype=m.dtype))
        else:
            assert m.dim() >= 2
            scale = 0.02 if path[-1] == "embed" else \
                (m.shape[0] if m.dim() <= 2 else m.shape[-2]) ** -0.5
            mats.setdefault(m.dtype, []).append((path, m.shape, scale))
    for dtype, entries in mats.items():
        flat = torch.randn(sum(math.prod(s) for _, s, _ in entries),
                           generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape, scale in entries:
            n = math.prod(shape)
            weights._set(params, path,
                         flat[off:off + n].view(shape).mul_(scale))
            off += n
    return params


def _reduced(name, dtype=None):
    from repro_torch.configs import base
    cfg = base.reduced(base.get_config(name))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    return cfg


def _digest(params):
    h = hashlib.sha256()
    for path, leaf in weights._paths(params):
        h.update(repr(path).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [7, 2**31 + 21])
def test_qwen3_4b_is_bitwise_the_dense_rule(dtype, seed):
    cfg = _reduced("qwen3_4b", dtype)
    got = weights.make(cfg, seed, "cpu")
    want = _parent_make(cfg, seed, "cpu")
    pairs = list(zip(weights._paths(got), weights._paths(want)))
    assert len(pairs) == len(list(weights._paths(want)))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


def test_qwen3_4b_checksum_from_before_the_rules_covered_every_leaf():
    """The reduced qwen3-4b tree in float32 from seed 2**31 + 21, by the
    dense rule as it stood (sha256 over each leaf's path and bytes)."""
    params = weights.make(_reduced("qwen3_4b"), 2**31 + 21, "cpu")
    assert _digest(params) == \
        "71966b1af2d9aa1474fae7840ed6f5df8fa5470fe2036516105d8a4b4b03e1e2"


@pytest.mark.parametrize("path, shape, scale", [
    (("embed",), (512, 256), 0.02),
    (("lm_head",), (256, 512), 256 ** -0.5),
    (("final_norm",), (256,), None),
    (("blocks", 0, "norm1"), (2, 256), None),
    (("blocks", 0, "norm_x"), (2, 256), None),
    (("blocks", 0, "gnorm"), (2, 512), None),
    (("blocks", 0, "attn", "q_norm"), (2, 64), None),
    # a stacked matrix: fan-in its second-to-last axis, never the stack
    (("blocks", 0, "attn", "wq"), (2, 256, 512), 256 ** -0.5),
    (("blocks", 0, "moe", "w_down"), (2, 4, 512, 256), 512 ** -0.5),
    (("blocks", 0, "r"), (2, 4, 4, 64, 64), 64 ** -0.5),
    (("blocks", 0, "conv_w"), (9, 4, 544), 4 ** -0.5),
    # the shared block is not stacked
    (("shared_attn", "attn", "wq"), (256, 512), 256 ** -0.5),
    (("encoder", "blocks", "attn", "wo"), (2, 512, 256), 512 ** -0.5),
    # a vector a layer, stacked: its stack is not a fan-in either
    (("blocks", 0, "A_log"), (9, 8), weights.VECTOR_SCALE),
    (("blocks", 0, "dt_bias"), (1, 80), weights.VECTOR_SCALE),
    (("blocks", 0, "D"), (9, 8), weights.VECTOR_SCALE),
    (("blocks", 0, "conv_b"), (9, 544), weights.VECTOR_SCALE),
    (("blocks", 0, "f_bias"), (6, 4), weights.VECTOR_SCALE),
    (("blocks", 0, "bias"), (6, 1024), weights.VECTOR_SCALE),
    (("blocks", 1, "gate"), (5,), weights.VECTOR_SCALE),
])
def test_the_rule_of_a_leaf(path, shape, scale):
    assert weights.rule(path, shape) == scale


@pytest.mark.parametrize("name", ALL)
def test_every_leaf_of_every_configuration_is_drawn_by_its_rule(name):
    cfg = _reduced(name)
    params = weights.make(cfg, 2**31 + 9, "cpu")
    from repro_torch.models import model
    meta = model.init_params(cfg, device="meta")
    got = dict(weights._paths(params))
    assert set(got) == {p for p, _ in weights._paths(meta)}
    for path, m in weights._paths(meta):
        leaf = got[path]
        assert leaf.shape == m.shape and leaf.dtype == m.dtype, path
        scale = weights.rule(path, m.shape)
        if scale is None:
            assert torch.equal(leaf, torch.ones_like(leaf)), path
            continue
        # randn scaled: its spread is the rule's scale, not the stack's
        x = leaf.double().reshape(-1)
        assert (x != 0).all(), path
        if x.numel() >= 256:
            assert x.std().item() == pytest.approx(scale, rel=0.25), path
    # the same seed draws the same tree; another seed another
    again = weights.make(cfg, 2**31 + 9, "cpu")
    assert _digest(again) == _digest(params)
    assert _digest(weights.make(cfg, 2**31 + 10, "cpu")) != _digest(params)
