"""The port's qwen3 model against the JAX package's, on the reduced config.

Weights come from the reference's ``init_params`` through ``np.asarray``
and the bridge; prompts from a numpy seed.  Tolerances:

- f32: 5e-5 absolute and relative.  The two frameworks sum the same
  products in different orders over two layers; the measured gap on these
  shapes is under 6e-6 at logit magnitudes near 4.
- bf16: 6e-2.  The frameworks round to bf16 at different points, and one
  bf16 step at magnitude 4 is 0.031; the measured gap is at most 0.04.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import kvcache as ref_kvcache, layers as ref_layers, \
    model as ref_model
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.models import kvcache, layers, model

TOL = {"float32": 5e-5, "bfloat16": 6e-2}
MAXLEN = 24


def _configs(dtype):
    rc = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    pc = base.reduced(base.get_config("qwen3-4b"))
    if dtype != "float32":
        rc = dataclasses.replace(rc, dtype=dtype, param_dtype=dtype)
        pc = dataclasses.replace(pc, dtype=dtype, param_dtype=dtype)
    return rc, pc


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    rc, pc = _configs(request.param)
    rp = ref_model.init_params(jax.random.key(0), rc)
    return request.param, rc, pc, rp, _bridge.to_torch(
        jax.tree.map(np.asarray, rp), "cpu")


def _t(a):
    return _bridge.array_to_torch(np.asarray(a), "cpu").float()


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _t(want).numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_config_matches_reference():
    rc, pc = _configs("float32")
    for f in dataclasses.fields(pc):
        assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    full, ref_full = base.get_config("qwen3_4b"), ref_base.get_config(
        "qwen3_4b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.hd, full.d_ff, full.vocab_size) == (
        ref_full.num_layers, ref_full.d_model, ref_full.num_heads,
        ref_full.num_kv_heads, ref_full.hd, ref_full.d_ff, ref_full.vocab_size)
    assert base.repeat_unit(full) == ref_base.repeat_unit(ref_full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(dtype):
    """Same keys, shapes and dtypes as the reference's tree, and the
    reference's distributions (normal * fan_in**-0.5, embed * 0.02, ones)."""
    rc, pc = _configs(dtype)
    ref_tree = jax.tree_util.tree_flatten_with_path(
        ref_model.init_params(jax.random.key(0), rc))[0]
    port = model.init_params(pc, seed=3, device="cpu")
    flat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            flat[path] = tree
    walk(port, ())
    assert len(flat) == len(ref_tree)
    for kp, leaf in ref_tree:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp)
        assert tuple(flat[key].shape) == leaf.shape, key
        assert str(flat[key].dtype).removeprefix("torch.") == leaf.dtype.name
    wq = port["blocks"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() * pc.d_model ** 0.5 - 1.0) < 0.05
    assert abs(port["embed"].float().std().item() / 0.02 - 1.0) < 0.05
    assert torch.equal(port["final_norm"], torch.ones_like(port["final_norm"]))


@pytest.mark.parametrize("B,S", [(1, 10), (2, 12), (1, MAXLEN)])
def test_prefill_logits_and_cache_match_reference(pair, B, S):
    dtype, rc, pc, rp, pp = pair
    toks = np.random.default_rng(B * 100 + S).integers(
        0, pc.vocab_size, size=(B, S)).astype(np.int32)
    rlog, rcache = ref_model.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                     ref_kvcache.init_cache(rc, B, MAXLEN))
    plog, pcache = model.prefill(pp, pc, {"tokens": torch.from_numpy(toks)
                                          .long()},
                                 kvcache.init_cache(pc, B, MAXLEN, "cpu"))
    assert plog.dtype == torch.float32 and plog.shape == (B, pc.vocab_size)
    _close(plog, rlog, dtype)
    for key in ("k", "v"):
        leaf = pcache["blocks"][0][key]
        assert str(leaf.dtype).removeprefix("torch.") == pc.dtype
        assert leaf.shape == rcache["blocks"][0][key].shape
        _close(leaf, rcache["blocks"][0][key], dtype)


def test_decode_teacher_forced_matches_reference(pair):
    """Both sides fed the reference's greedy tokens, step by step."""
    dtype, rc, pc, rp, pp = pair
    B, S = 2, 9
    toks = np.random.default_rng(7).integers(
        0, pc.vocab_size, size=(B, S)).astype(np.int32)
    rlog, rcache = ref_model.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                     ref_kvcache.init_cache(rc, B, MAXLEN))
    _, pcache = model.prefill(pp, pc, {"tokens": torch.from_numpy(toks)
                                       .long()},
                              kvcache.init_cache(pc, B, MAXLEN, "cpu"))
    pos = np.full((B,), S, np.int32)
    for _ in range(MAXLEN - S):
        tok = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)
        rlog, rcache = ref_model.decode_step(rp, rc, jnp.asarray(tok)[:, None],
                                             jnp.asarray(pos), rcache)
        plog, pcache = model.decode_step(
            pp, pc, torch.from_numpy(tok).long()[:, None],
            torch.from_numpy(pos).long(), pcache)
        _close(plog, rlog, dtype)
        pos = pos + 1
    for key in ("k", "v"):
        _close(pcache["blocks"][0][key], rcache["blocks"][0][key], dtype)


def test_decode_past_the_cache_is_dropped():
    """A position at the cache width writes nothing, as the reference's
    out-of-bounds scatter drops it."""
    _, pc = _configs("float32")
    pp = model.init_params(pc, device="cpu")
    cache = kvcache.init_cache(pc, 1, 4, "cpu")
    _, new = model.decode_step(pp, pc, torch.tensor([[5]]),
                               torch.tensor([4]), cache)
    assert torch.equal(new["blocks"][0]["k"], cache["blocks"][0]["k"])


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 7, 4, 32)])
def test_norm_and_rope_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    if len(shape) == 4:
        pos = np.arange(shape[1])[None].repeat(shape[0], 0).astype(np.int32)
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6).numpy(),
            np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                             1e6)),
            atol=1e-5, rtol=1e-5)


def test_unported_families_raise():
    cfg = dataclasses.replace(base.reduced(base.get_config("qwen3-4b")),
                              attention="swa")
    with pytest.raises(NotImplementedError):
        model.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        kvcache.init_cache(cfg, 1, 128, "cpu")
    with pytest.raises(KeyError):
        base.get_config("zamba2_2_7b")
