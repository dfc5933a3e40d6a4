"""The three policy fields the reference's model reads, against the JAX
package's model under the same policy: ``attn_repeat_kv``,
``decode_onehot_update`` and ``attn_impl``.

Weights come from the reference's ``init_params`` through the bridge,
prompts from a numpy seed, f32 throughout; tolerances are the
reference's 2e-5 (``tests/test_kernels.py``), and the trainer's for
gradients (``tests/test_torch_trainer.py``: rtol 2e-4, atol 2e-6).  Both
reduced configurations have one K/V head a query head, so each is run
with two query heads a K/V head (``num_kv_heads=2``) on both sides: at a
ratio of 1 the repeat is a no-op in either package.  qwen3-4b is the GQA
configuration with a dense cache, h2o-danube-3-4b the sliding-window one,
whose cache is a ring at a 70-token prompt above its reduced window of
64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch import policy as ref_policy
from repro.models import kvcache as ref_kvcache, model as ref_model
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.launch import dryrun, policy
from repro_torch.models import kvcache, model
from repro_torch.roofline import counter
from repro_torch.train import train_step as ts
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = 2e-5
RTOL, ATOL = 2e-4, 2e-6
STEPS = 4
# (arch, prompt length, cache length)
CASES = {"qwen3_4b": (12, 24), "h2o_danube_3_4b": (70, 80)}


def _cfgs(arch, **over):
    over.setdefault("num_kv_heads", 2)
    return (dataclasses.replace(ref_base.reduced(ref_base.get_config(arch)),
                                **over),
            dataclasses.replace(base.reduced(base.get_config(arch)), **over))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    rc, pc = _cfgs(request.param)
    assert pc.q_per_kv == 2
    rp = ref_model.init_params(jax.random.key(0), rc)
    return request.param, rc, pc, rp, _bridge.to_torch(
        jax.tree.map(np.asarray, rp), "cpu")


def _t(a):
    return _bridge.array_to_torch(np.asarray(a), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _t(want).float().numpy(),
                               atol=tol, rtol=tol)


def _tokens(pc, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, pc.vocab_size, size=(B, S)).astype(np.int32)


def _ref_run(rc, rp, toks, ML, fields, steps=STEPS):
    """The reference's prefill and ``steps`` greedy decode steps under
    ``fields``: [(logits, cache)] per step, and the tokens fed."""
    B, S = toks.shape
    with ref_policy.use(ref_policy.PerfPolicy(**fields)):
        out = [ref_model.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                 ref_kvcache.init_cache(rc, B, ML))]
        fed = []
        for i in range(steps):
            tok = np.asarray(jnp.argmax(out[-1][0], -1)).astype(np.int32)
            fed.append(tok)
            out.append(ref_model.decode_step(
                rp, rc, jnp.asarray(tok)[:, None],
                jnp.full((B,), S + i, jnp.int32), out[-1][1]))
    return out, fed


def _port_run(pc, pp, toks, ML, fields, fed):
    """The port's prefill and decode steps under ``fields``, fed the
    reference's tokens."""
    B, S = toks.shape
    with policy.use(policy.PerfPolicy(**fields)), torch.no_grad():
        out = [model.prefill(pp, pc, {"tokens": torch.from_numpy(toks)
                                      .long()},
                             kvcache.init_cache(pc, B, ML, "cpu"))]
        for i, tok in enumerate(fed):
            out.append(model.decode_step(
                pp, pc, torch.from_numpy(tok).long()[:, None],
                torch.full((B,), S + i), out[-1][1]))
    return out


def _check_run(got, want):
    for (plog, pcache), (rlog, rcache) in zip(got, want):
        _close(plog, rlog)
        assert len(pcache["blocks"]) == len(rcache["blocks"])
        for pentry, rentry in zip(pcache["blocks"], rcache["blocks"]):
            assert sorted(pentry) == sorted(rentry)
            for key, leaf in pentry.items():
                assert tuple(leaf.shape) == rentry[key].shape, key
                if key == "kpos":
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(rentry[key]))
                else:
                    _close(leaf, rentry[key])


def test_policy_equals_the_reference():
    """The same fields, in the same order, with the same defaults: the
    dry-run record's ``"policy"`` dict is the reference's."""
    got = dataclasses.asdict(policy.PerfPolicy())
    want = dataclasses.asdict(ref_policy.PerfPolicy())
    assert list(got.items()) == list(want.items())
    assert [f.type for f in dataclasses.fields(policy.PerfPolicy)] == \
        [f.type for f in dataclasses.fields(ref_policy.PerfPolicy)]


def test_parse_overrides_takes_every_field():
    """Every field of the reference parses, with the reference's values;
    an unknown attention implementation is refused."""
    pairs = ["attn_impl=flash", "attn_block_q=128", "attn_block_k=256",
             "attn_p_bf16=1", "attn_qk_bf16=1", "logits_bf16=1",
             "ce_chunk=64", "fsdp_gather_weights=1", "param_tp_only=1",
             "attn_repeat_kv=1", "hidden_spec=dshard",
             "seq_parallel_hidden=1", "moe_expert_shard=1",
             "decode_onehot_update=true", "decode_replicate_small_cache=1",
             "small_cache_bytes=4096", "overlap_grad_reduce=0"]
    assert {p.split("=")[0] for p in pairs} == \
        set(ref_policy.PerfPolicy.__dataclass_fields__)
    got = policy.parse_overrides(pairs)
    want = ref_policy.parse_overrides(pairs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attn_repeat_kv and got.decode_onehot_update and \
        got.attn_impl == "flash"
    assert policy.parse_overrides(["attn_impl=blockwise"]) == \
        policy.PerfPolicy()
    for bad in ("attn_impl=pallas", "attn_impl=Flash"):
        with pytest.raises(ValueError, match="attn_impl"):
            policy.parse_overrides([bad])
    with pytest.raises(ValueError, match="attn_impl"):
        policy.PerfPolicy(attn_impl="xla")


def test_repeat_kv_prefill_and_decode_match_reference(pair):
    """Prefill logits and cache, then 4 greedy decode steps, under
    ``attn_repeat_kv=1``; the cache keeps the unrepeated K/V heads."""
    arch, rc, pc, rp, pp = pair
    S, ML = CASES[arch]
    toks = _tokens(pc, 2, S)
    fields = {"attn_repeat_kv": True}
    want, fed = _ref_run(rc, rp, toks, ML, fields)
    got = _port_run(pc, pp, toks, ML, fields, fed)
    assert got[0][1]["blocks"][0]["k"].shape[-2] == pc.num_kv_heads
    if arch == "h2o_danube_3_4b":
        assert "kpos" in got[-1][1]["blocks"][0]
    _check_run(got, want)


def test_repeat_kv_train_loss_and_grads_match_reference(pair):
    """``train_loss`` and its gradients under ``attn_repeat_kv=1``,
    against ``jax.value_and_grad`` of the reference's."""
    arch, rc, pc, rp, pp = pair
    toks = _tokens(pc, 2, 33, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with ref_policy.use(ref_policy.PerfPolicy(attn_repeat_kv=True)):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_model.train_loss(p, rc, b), has_aux=True))(
                rp, {k: jnp.asarray(v) for k, v in batch.items()})
    with policy.use(policy.PerfPolicy(attn_repeat_kv=True)):
        ploss, _, pgrads = ts.value_and_grad(
            pp, pc, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ploss), float(loss), rtol=TOL)
    want = jax.tree.leaves(grads)
    assert len(pgrads) == len(want)
    for g, w in zip(pgrads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_onehot_update_decode_matches_reference(pair):
    """Under ``decode_onehot_update=1`` the reference writes its cache by
    the one-hot select the port always uses: the port's decode is held
    against that branch, and is bitwise its own default."""
    arch, rc, pc, rp, pp = pair
    S, ML = CASES[arch]
    toks = _tokens(pc, 2, S, seed=2)
    fields = {"decode_onehot_update": True}
    want, fed = _ref_run(rc, rp, toks, ML, fields)
    got = _port_run(pc, pp, toks, ML, fields, fed)
    _check_run(got, want)
    default = _port_run(pc, pp, toks, ML, {}, fed)
    for (glog, gcache), (dlog, dcache) in zip(got, default):
        assert torch.equal(glog, dlog)
        for gentry, dentry in zip(gcache["blocks"], dcache["blocks"]):
            for key in gentry:
                assert torch.equal(gentry[key], dentry[key])


def test_flash_prefill_matches_the_reference_kernel():
    """Under ``attn_impl=flash`` the reference's prefill runs its Pallas
    kernel (interpret mode on the CPU); the port's runs K2's wrapper, as
    it does under the default.  Logits and cache within 2e-5."""
    rc, pc = _cfgs("qwen3_4b")
    rp = ref_model.init_params(jax.random.key(0), rc)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    toks = _tokens(pc, 2, 16, seed=3)
    fields = {"attn_impl": "flash"}
    want, fed = _ref_run(rc, rp, toks, 24, fields, steps=1)
    got = _port_run(pc, pp, toks, 24, fields, fed)
    _check_run(got, want)


def test_flash_trains_forward_only():
    """Under ``attn_impl=flash`` the train-mode forward goes through K2's
    wrapper, as the reference's goes through its kernel: ``train_loss``
    without a gradient equals the reference's.  A gradient through it
    raises ``NotImplementedError`` naming the reason (the reference fails
    in ``pallas_call``'s JVP rule), whether the remat recomputes the
    layer or not: no other attention is taken."""
    rc, pc = _cfgs("qwen3_4b")
    rp = ref_model.init_params(jax.random.key(0), rc)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    toks = _tokens(pc, 2, 17, seed=4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with ref_policy.use(ref_policy.PerfPolicy(attn_impl="flash")):
        loss, _ = ref_model.train_loss(
            rp, rc, {k: jnp.asarray(v) for k, v in batch.items()})
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = []
    real = model.flash_attn.flash_attention

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)
    model.flash_attn.flash_attention = spy
    try:
        with policy.use(policy.PerfPolicy(attn_impl="flash")):
            with torch.no_grad():
                ploss, _ = model.train_loss(pp, pc, pbatch)
            for remat in (False, True):
                cfg = dataclasses.replace(pc, remat=remat)
                with pytest.raises(NotImplementedError,
                                   match="forward-only.*JVP"):
                    ts.value_and_grad(pp, cfg, pbatch)
    finally:
        model.flash_attn.flash_attention = real
    np.testing.assert_allclose(float(ploss), float(loss), rtol=TOL)
    assert calls[:pc.num_layers] == [(2, 16, pc.num_heads, pc.hd)] * \
        pc.num_layers
    # the default policy trains as before, through no K2
    calls.clear()
    ts.value_and_grad(pp, pc, pbatch)
    assert calls == []


def test_repeat_kv_dry_run_charges_k2_as_mha():
    """A meta record under ``attn_repeat_kv=1`` counts exactly what the
    same step counts on CPU tensors, charges K2 at ``Hkv = H``, and its
    bytes exceed the default record's by the repeat's copies and K2's
    larger K/V reads, with the same operations."""
    _, pc = _cfgs("qwen3_4b")
    shape = base.ShapeSpec("p", "prefill", 16, 2)
    pol = policy.parse_overrides(["attn_repeat_kv=1"])
    rec = dryrun.run_one("qwen3_4b", shape, "card", cfg=pc, policy=pol)
    plain = dryrun.run_one("qwen3_4b", shape, "card", cfg=pc)
    assert rec["status"] == plain["status"] == "ok"
    assert rec["policy"] == dataclasses.asdict(pol) and \
        rec["policy"]["attn_repeat_kv"]
    with policy.use(pol):
        fn, args = dryrun.build_step(pc, shape, device="cpu", seed=3)
        _, real = dryrun.count_step(fn, args)
    assert rec["counted"] == {k: real[k] for k in rec["counted"]}
    B, S, H, hd = 2, 16, pc.num_heads, pc.hd
    k2 = rec["counted"]["by_kernel"]["flash_attention"]
    one = counter.flash_work(B, S, H, H, hd, 4)
    assert k2["calls"] == pc.num_layers
    assert k2["bytes"] == pc.num_layers * one["bytes"]
    assert k2["flops"] == pc.num_layers * one["flops"]
    gqa = plain["counted"]["by_kernel"]["flash_attention"]
    assert gqa["bytes"] == pc.num_layers * counter.flash_work(
        B, S, H, pc.num_kv_heads, hd, 4)["bytes"]
    assert rec["counted"]["flops"] == plain["counted"]["flops"]
    # each layer copies K and V to H heads: 2 x (B, S, H, hd) f32 written
    # from (B, S, Hkv, hd) read
    kv = B * S * hd * 4
    copies = pc.num_layers * 2 * (kv * H + kv * pc.num_kv_heads)
    assert rec["counted"]["bytes"] - plain["counted"]["bytes"] >= \
        copies + k2["bytes"] - gqa["bytes"]
