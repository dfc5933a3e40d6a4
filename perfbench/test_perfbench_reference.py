"""CPU tests of the plain references: hand-worked tiny cases, the float8
control's rounding, and agreement with the program's own forward pass at
a reduced size (float32), position by position."""
import dataclasses
import math

import pytest
import torch

from perfbench import weights
from perfbench.reference import common, dense


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rms_and_rope_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    assert common.rms(x, torch.ones(2), eps=0.0) == pytest.approx(
        x / math.sqrt(12.5))
    v = torch.tensor([[[1.0, 0.0, 2.0, 0.0]]]).repeat(3, 1, 1)  # (S,1,4)
    r = common.rope(v, theta=10000.0)
    # position 0 is the identity; position p turns pair 0 by p radians
    assert torch.allclose(r[0], v[0])
    p = 2
    c, s = math.cos(p), math.sin(p)
    assert r[p, 0, 0].item() == pytest.approx(1.0 * c - 2.0 * s, abs=1e-6)
    assert r[p, 0, 2].item() == pytest.approx(1.0 * s + 2.0 * c, abs=1e-6)


def test_attention_of_equal_keys_averages_the_values():
    a = {"num_heads": 1, "num_kv_heads": 1, "head_dim": 2, "d_model": 2,
         "qk_norm": False, "rope_theta": 1e4}
    eye = torch.eye(2)
    p = {"wq": torch.zeros(2, 2), "wk": torch.zeros(2, 2), "wv": eye,
         "wo": eye}
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    out = common.attention(p, x, a, common.f32_weight)
    # zero queries and keys: uniform weights over the causal prefix
    want = torch.stack([x[:1].mean(0), x[:2].mean(0), x.mean(0)])
    assert torch.allclose(out, want)


def test_fp8_control_rounds_each_matrix():
    t = torch.randn(64, 32)
    q = common.fp8_weight(t)
    assert not torch.equal(q, t)
    rel = ((q - t).abs() / t.abs().amax(0, keepdim=True)).max()
    assert 0 < rel <= 2.0 ** -4
    v = torch.randn(8)
    assert torch.equal(common.fp8_weight(v), v)


def _reduced(name):
    from repro_torch.configs import base
    return base.reduced(base.get_config(name))


@pytest.mark.parametrize("tie", [True, False])
def test_reference_follows_the_program_at_a_reduced_size(tie):
    from repro_torch.models import kvcache, model
    cfg = dataclasses.replace(_reduced("qwen3_4b"), tie_embeddings=tie)
    arch = dataclasses.asdict(cfg)
    params = weights.make(cfg, 2**31 + 3, "cpu")
    g = torch.Generator().manual_seed(0)
    S = 13
    tokens = torch.randint(0, cfg.vocab_size, (S,), generator=g)
    want = dense.logits(params, arch, tokens, torch.arange(S))
    for t in (0, 6, S - 1):
        cache = kvcache.init_cache(cfg, 1, S, "cpu")
        got, _ = model.prefill(params, cfg, {"tokens": tokens[None, :t + 1]},
                               cache)
        assert torch.allclose(got[0], want[t], atol=2e-4, rtol=2e-4), t
