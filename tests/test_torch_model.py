"""The port's models against the JAX package's, on the reduced configs:
qwen3-4b (dense attention), zamba2-2.7b (Mamba2 with the weight-shared
attention block) and xlstm-125m (mLSTM and sLSTM).

Weights come from the reference's ``init_params`` through ``np.asarray``
and the bridge; prompts from a numpy seed.  Tolerances:

- f32: 5e-5 absolute and relative for qwen3; the reference's 2e-5 for
  zamba2 and xlstm.  The two frameworks sum the same products in different
  orders; the measured gap is under 6e-6 for qwen3 and under 1.2e-5 for
  the recurrent families, at logit magnitudes near 3.5-4.
- bf16: 6e-2.  The frameworks round to bf16 at different points, and one
  bf16 step at magnitude 4 is 0.031.  The measured gap is at most 0.04
  for qwen3 and xlstm and 0.15 for zamba2's six layers, where the
  reference differs from itself by 0.094 at logit magnitude 3.5 when only
  XLA's excess-precision flag changes (``--xla_allow_excess_precision``):
  the reference's 2e-2 is below its own rounding spread at that depth.
  One Mamba2 or xLSTM layer alone meets 2e-2 (``tests/test_torch_ssm.py``).
  The recurrent families' bf16 logits and cache leaves are held by their
  relative L2 error, within the same 6e-2 (measured at most 0.029, zamba2's
  prefill logits, where the reference's own spread above reads 0.017-0.028
  over six decode steps): an element near zero carries the absolute spread
  of the layers above it, which no elementwise bound at bf16 separates
  from a fault.
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
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = {"float32": 5e-5, "bfloat16": 6e-2}
TOL_RECURRENT = {"float32": 2e-5, "bfloat16": 6e-2}
MAXLEN = 24
RECURRENT = ("zamba2_2_7b", "xlstm_125m")


def _configs(dtype, arch="qwen3_4b"):
    rc = ref_base.reduced(ref_base.get_config(arch))
    pc = base.reduced(base.get_config(arch))
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


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _t(want).numpy(),
                               atol=tol[dtype], rtol=tol[dtype])


def test_config_matches_reference():
    for arch in ("qwen3_4b",) + RECURRENT:
        rc, pc = _configs("float32", arch)
        full, ref_full = base.get_config(arch), ref_base.get_config(arch)
        for f in dataclasses.fields(pc):
            assert getattr(pc, f.name) == getattr(rc, f.name), (arch, f.name)
            assert getattr(full, f.name) == getattr(ref_full, f.name), \
                (arch, f.name)
        assert base.repeat_unit(full) == ref_base.repeat_unit(ref_full)
        assert base.layer_kinds(full) == ref_base.layer_kinds(ref_full)
    assert base.get_config("zamba2-2.7b").hd == 80


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(dtype):
    """Same keys, shapes and dtypes as the reference's tree, and the
    reference's distributions (normal * fan_in**-0.5, embed * 0.02, ones)."""
    _check_init_tree(dtype, "qwen3_4b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_params_tree_matches_reference(arch, dtype):
    """The same for zamba2 (the ``{}`` placeholder at the shared block's
    position, its weights unstacked under ``shared_attn``) and xlstm (f32
    gates and recurrent weights beside the activation-dtype projections),
    and the bridge carries the reference's tree across unchanged."""
    _check_init_tree(dtype, arch)
    rc, pc = _configs(dtype, arch)
    rp = ref_model.init_params(jax.random.key(0), rc)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    if arch == "zamba2_2_7b":
        assert pp["blocks"][5] == {} and rp["blocks"][5] == {}
        assert pp["shared_attn"]["attn"]["wq"].shape == (
            pc.d_model, pc.num_heads * pc.hd)
    assert len(pp["blocks"]) == len(rp["blocks"])


def _close_recurrent(leaf, want, dtype):
    """A recurrent family's logits or cache leaf: elementwise in f32, by
    the relative L2 error in bf16 (see the module docstring)."""
    if dtype == "float32":
        _close(leaf, want, dtype, TOL_RECURRENT)
        return
    got, ref = leaf.float().numpy(), _t(want).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - ref) <= TOL_RECURRENT[dtype] * \
        np.linalg.norm(ref)


def _check_init_tree(dtype, arch):
    rc, pc = _configs(dtype, arch)
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
    block = port["blocks"][0]
    wq = (block["attn"]["wq"] if "attn" in block else block["wx"]).float()
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


@pytest.fixture(scope="module", params=[
    (arch, dtype) for arch in RECURRENT for dtype in ("float32", "bfloat16")],
    ids=lambda p: "-".join(p))
def recurrent_pair(request):
    arch, dtype = request.param
    rc, pc = _configs(dtype, arch)
    rp = ref_model.init_params(jax.random.key(0), rc)
    return dtype, rc, pc, rp, _bridge.to_torch(
        jax.tree.map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("B,S", [(1, 10), (2, 17)])
def test_recurrent_prefill_logits_and_cache_match_reference(recurrent_pair,
                                                            B, S):
    """Prefill logits and every cache leaf (K/V of each shared-attention
    repeat, Mamba2 states and conv windows, mLSTM and sLSTM states), with
    the leaves' dtypes: at bf16 the conv window leaves prefill in the
    activation dtype, as the reference's does."""
    dtype, rc, pc, rp, pp = recurrent_pair
    toks = np.random.default_rng(B * 100 + S).integers(
        0, pc.vocab_size, size=(B, S)).astype(np.int32)
    rlog, rcache = ref_model.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                     ref_kvcache.init_cache(rc, B, MAXLEN))
    plog, pcache = model.prefill(pp, pc, {"tokens": torch.from_numpy(toks)
                                          .long()},
                                 kvcache.init_cache(pc, B, MAXLEN, "cpu"))
    assert plog.dtype == torch.float32 and plog.shape == (B, pc.vocab_size)
    _close_recurrent(plog, rlog, dtype)
    assert len(pcache["blocks"]) == len(rcache["blocks"])
    for rentry, pentry in zip(rcache["blocks"], pcache["blocks"]):
        assert sorted(rentry) == sorted(pentry)
        for key, leaf in pentry.items():
            want = rentry[key]
            assert tuple(leaf.shape) == want.shape, key
            assert str(leaf.dtype).removeprefix("torch.") == \
                want.dtype.name, key
            _close_recurrent(leaf, want, dtype)


def test_recurrent_decode_teacher_forced_matches_reference(recurrent_pair):
    """Both sides fed the reference's greedy tokens, step by step, from
    their own prefill caches; the caches agree at the end."""
    dtype, rc, pc, rp, pp = recurrent_pair
    B, S = 2, 9
    toks = np.random.default_rng(7).integers(
        0, pc.vocab_size, size=(B, S)).astype(np.int32)
    rlog, rcache = ref_model.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                     ref_kvcache.init_cache(rc, B, MAXLEN))
    _, pcache = model.prefill(pp, pc, {"tokens": torch.from_numpy(toks)
                                       .long()},
                              kvcache.init_cache(pc, B, MAXLEN, "cpu"))
    pos = np.full((B,), S, np.int32)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)
        rlog, rcache = ref_model.decode_step(rp, rc, jnp.asarray(tok)[:, None],
                                             jnp.asarray(pos), rcache)
        plog, pcache = model.decode_step(
            pp, pc, torch.from_numpy(tok).long()[:, None],
            torch.from_numpy(pos).long(), pcache)
        _close_recurrent(plog, rlog, dtype)
        pos = pos + 1
    for rentry, pentry in zip(rcache["blocks"], pcache["blocks"]):
        for key, leaf in pentry.items():
            assert str(leaf.dtype).removeprefix("torch.") == \
                rentry[key].dtype.name, key
            _close_recurrent(leaf, rentry[key], dtype)


def test_recurrent_cache_shapes_match_reference():
    """The decode cache's structure, leaf for leaf: the reference's
    ``cache_struct`` shapes and dtypes."""
    for arch in RECURRENT:
        for dtype in ("float32", "bfloat16"):
            rc, pc = _configs(dtype, arch)
            want = ref_kvcache.cache_struct(rc, 3, MAXLEN)["blocks"]
            got = kvcache.cache_shapes(pc, 3, MAXLEN)["blocks"]
            assert len(got) == len(want)
            for rentry, pentry in zip(want, got):
                assert {k: (tuple(v.shape), v.dtype.name)
                        for k, v in rentry.items()} == pentry


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


def test_training_mode_raises():
    """Only a mode that is none of train, prefill and decode raises, in
    ``backbone`` and ``apply_block``, instead of falling into the decode
    branch.  Training is ported (it raised before): ``mode="train"``
    returns the hidden states, no cache and the f32 auxiliary loss, 0 for
    a dense model."""
    _, pc = _configs("float32")
    pp = model.init_params(pc, device="cpu")
    x = torch.zeros((1, 4, pc.d_model))
    positions = torch.arange(4)[None]
    y, cache, aux = model.backbone(pp, pc, x, mode="train",
                                   positions=positions)
    assert y.shape == x.shape and cache is None
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    y1, nc, a = model.apply_block("attn", model._layer(pp["blocks"][0], 0),
                                  x, cfg=pc, mode="train",
                                  positions=positions)
    assert y1.shape == x.shape and nc == {} and a is None
    with pytest.raises(ValueError):
        model.backbone(pp, pc, x, mode="score", positions=positions)
    with pytest.raises(ValueError):
        model.apply_block("attn", model._layer(pp["blocks"][0], 0), x,
                          cfg=pc, mode="score", positions=positions)
