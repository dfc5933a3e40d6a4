"""The port's training units against the JAX package's, on the same numpy
inputs: the optimizers (one update from one bridged state, f32, rtol
2e-5), the schedule, the clip and weight decay (the laws of
``tests/test_optimizer.py``), the token stream (bitwise, plus the laws of
``tests/test_data.py``), checkpoints (round trip, retention, errors, and
restore across packages in both directions on f32 trees), the modeled
gradient-reduce schedule (equal to the reference's) and the policy's
overrides.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import api as ref_api
from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipe
from repro.launch import policy as ref_policy
from repro.models import model as ref_model
from repro.train import checkpoint as ref_ck, optimizer as ref_opt, \
    train_step as ref_ts
from repro_torch import _bridge
from repro_torch.comms import api
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch import policy
from repro_torch.models import model
from repro_torch.train import checkpoint as ck, optimizer as opt, \
    train_step as ts, tree as tree_mod
from _torch_threads import one_intra_op_thread  # noqa: F401

RTOL = 2e-5


def _np_tree(seed):
    """Stacked matrices, a stacked norm, a vector and a matrix with a unit
    axis (not factored by Adafactor)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"blocks": [{"w": f(2, 8, 16), "norm": f(2, 16)}],
            "bias": f(16), "col": f(12, 1), "embed": f(32, 8)}


def _torch(tree):
    return _bridge.to_torch(tree, "cpu")


def _close(got, want, rtol=RTOL, atol=1e-7):
    for (k, a), b in zip(tree_mod.flatten(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference_from_one_state(name):
    """Two updates from one bridged state (after a reference step, so the
    moments are not zero): params, moments, lr and grad norm within 2e-5."""
    cfg = ref_opt.OptConfig(name=name, lr=0.05, warmup_steps=3,
                            total_steps=20, weight_decay=0.1, clip_norm=2.0)
    pcfg = opt.OptConfig(**dataclasses.asdict(cfg))
    rp = jax.tree.map(jnp.asarray, _np_tree(0))
    rs = ref_opt.init(name, rp)
    rp, rs, _ = ref_opt.update(name, rp, jax.tree.map(jnp.asarray,
                                                      _np_tree(1)), rs, cfg)
    pp = _torch(jax.tree.map(np.asarray, rp))
    ps = _bridge.opt_state_to_torch(jax.tree.map(np.asarray, rs), "cpu")
    for seed in (2, 3):
        g = _np_tree(seed)
        rp, rs, rm = ref_opt.update(name, rp, jax.tree.map(jnp.asarray, g),
                                    rs, cfg)
        pp, ps, pm = opt.update(name, pp, _torch(g), ps, pcfg)
        _close(pp, rp)
        _close({k: v for k, v in ps.items() if k != "step"},
               {k: v for k, v in rs.items() if k != "step"})
        assert int(ps["step"]) == int(rs["step"])
        assert ps["step"].dtype == torch.int32 and ps["step"].device.type \
            == "cpu"
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=RTOL)


def test_update_works_leaf_by_leaf_and_in_place():
    """The update writes into the tensors it is given and returns them."""
    pp = _torch(_np_tree(0))
    ps = opt.init("adamw", pp)
    w = pp["blocks"][0]["w"]
    out, st, _ = opt.update("adamw", pp, _torch(_np_tree(1)), ps,
                            opt.OptConfig(warmup_steps=1))
    assert out["blocks"][0]["w"] is w and st is ps
    assert int(st["step"]) == 1


def test_adafactor_state_is_factored():
    params = {"mat": torch.zeros((64, 32)), "vec": torch.zeros((16,)),
              "stack": torch.zeros((3, 64, 32))}
    state = opt.adafactor_init(params)
    ref = ref_opt.adafactor_init({k: jnp.zeros(v.shape)
                                  for k, v in params.items()})
    assert state["v"]["mat"]["vr"].shape == (64,)
    assert state["v"]["mat"]["vc"].shape == (32,)
    assert state["v"]["vec"]["v"].shape == (16,)
    assert state["v"]["stack"]["vc"].shape == (3, 32)
    assert [tuple(x.shape) for x in tree_mod.leaves(state)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref)]


def _rosenbrockish(params):
    x = params["w"]
    return torch.sum((x - 1.5) ** 2) + torch.sum(torch.abs(x[:2]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_loss(name):
    params = {"w": torch.zeros((8, 8)), "b": torch.zeros((8,))}
    cfg = opt.OptConfig(name=name, lr=0.05, warmup_steps=1, total_steps=100,
                        weight_decay=0.0)
    state = opt.init(name, params)
    loss0 = float(_rosenbrockish(params))
    for _ in range(60):
        w = params["w"].detach().requires_grad_(True)
        (gw,) = torch.autograd.grad(_rosenbrockish({"w": w}), [w])
        grads = {"w": gw, "b": torch.zeros(8)}
        params, state, _ = opt.update(name, params, grads, state, cfg)
    assert float(_rosenbrockish(params)) < 0.5 * loss0


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 100.0), "b": torch.full((3,), 7.0,
                                                        dtype=torch.bfloat16)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(opt.global_norm(clipped)) - 1.0) < 1e-5
    assert clipped["b"].dtype == torch.float32
    rnorm = ref_opt.global_norm({"a": jnp.full((10,), 100.0),
                                 "b": jnp.full((3,), 7.0, jnp.bfloat16)})
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)


def test_schedule_matches_reference_and_its_laws():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    rcfg = ref_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    lrs = [float(opt.schedule(cfg, s)) for s in range(0, 100, 5)]
    want = [float(ref_opt.schedule(rcfg, jnp.asarray(s)))
            for s in range(0, 100, 5)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert lrs[0] < lrs[1]                      # warming up
    assert lrs[-1] < lrs[3]                     # decayed
    assert lrs[-1] >= 0.1 * 0.99                # floor


def test_weight_decay_pulls_to_zero():
    params = {"w": torch.full((4,), 10.0)}
    cfg = opt.OptConfig(name="adamw", lr=0.1, warmup_steps=1, total_steps=50,
                        weight_decay=0.5)
    state = opt.adamw_init(params)
    for _ in range(20):
        params, state, _ = opt.adamw_update(params, {"w": torch.zeros(4)},
                                            state, cfg)
    assert float(params["w"].abs().max()) < 10.0


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (3, 17, 1),
                                            (12345, 1000, 3)])
def test_tokens_bitwise_equal_to_reference(seed, step, host):
    cfg = dict(vocab_size=512, seq_len=64, global_batch=8, seed=seed)
    want = ref_pipe.TokenStream(ref_pipe.DataConfig(**cfg)).batch(
        step, host_index=host, num_hosts=4)
    got = pipeline.TokenStream(pipeline.DataConfig(**cfg),
                               device="cpu").batch(step, host_index=host,
                                                   num_hosts=4)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def test_threefry_draws_equal_jax_random():
    for seed, data in ((0, 0), (7, 5), (2**31 - 1, 2**32 - 1)):
        k = jax.random.fold_in(jax.random.key(seed), data)
        pk = pipeline.fold_in(pipeline.key(seed), data)
        np.testing.assert_array_equal(pk, np.asarray(jax.random.key_data(k)))
        np.testing.assert_array_equal(
            pipeline.random_bits(pk, (5, 33)),
            np.asarray(jax.random.bits(k, (5, 33), jnp.uint32)))


def test_frontend_within_1e6_of_reference():
    cfg = dict(vocab_size=100, seq_len=16, global_batch=4, seed=2)
    s = pipeline.TokenStream(pipeline.DataConfig(**cfg), device="cpu")
    r = ref_pipe.TokenStream(ref_pipe.DataConfig(**cfg))
    for arch, key in (("whisper_medium", "audio_embeds"),
                      ("llama_3_2_vision_90b", "image_embeds")):
        pc = base.reduced(base.get_config(arch))
        rc = ref_base.reduced(ref_base.get_config(arch))
        got, want = s.frontend(3, pc, 4)[key], r.frontend(3, rc, 4)[key]
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def _stream(**kw):
    return pipeline.TokenStream(pipeline.DataConfig(**kw), device="cpu")


def test_data_laws():
    """``tests/test_data.py``: deterministic, shifted labels, host slices
    that partition the batch, a skewed marginal, frontend shapes."""
    s1, s2 = (_stream(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
              for _ in range(2))
    assert torch.equal(s1.batch(17)["tokens"], s2.batch(17)["tokens"])
    assert not torch.equal(s1.batch(17)["tokens"], s1.batch(18)["tokens"])
    b = _stream(vocab_size=100, seq_len=32, global_batch=4).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 32)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    s = _stream(vocab_size=100, seq_len=16, global_batch=8)
    parts = [s.batch(5, host_index=h, num_hosts=4) for h in range(4)]
    assert all(p["tokens"].shape == (2, 16) for p in parts)
    assert not torch.equal(parts[0]["tokens"], parts[1]["tokens"])
    toks = _stream(vocab_size=5000, seq_len=256, global_batch=16).batch(0)[
        "tokens"].ravel()
    assert 0 <= int(toks.min()) and int(toks.max()) < 5000
    assert float((toks < 50).double().mean()) > 0.3
    s = _stream(vocab_size=100, seq_len=16, global_batch=4)
    wcfg = base.reduced(base.get_config("whisper_medium"))
    assert s.frontend(0, wcfg, 4)["audio_embeds"].shape == \
        (4, wcfg.encoder_seq, wcfg.d_model)
    vcfg = base.reduced(base.get_config("llama_3_2_vision_90b"))
    assert s.frontend(0, vcfg, 4)["image_embeds"].shape == \
        (4, vcfg.image_tokens, vcfg.d_model)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ck_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(rng.standard_normal((8, 4))
                                        .astype(np.float32)),
                  "b": torch.arange(5, dtype=torch.int32)},
            "scale": torch.tensor(3.5),
            "blocks": [{"h": torch.from_numpy(rng.standard_normal(
                (2, 3)).astype(np.float32)).bfloat16()}]}


def test_checkpoint_roundtrip_with_bf16(tmp_path):
    t = (_ck_tree(), {"step": torch.tensor(7, dtype=torch.int32)})
    ck.save(str(tmp_path), 7, t)
    restored, meta = ck.restore(str(tmp_path), 7,
                                tree_mod.map_leaves(torch.zeros_like, t))
    assert meta["step"] == 7
    assert meta["dtypes"]["[0]['blocks'][0]['h']"] == "bfloat16"
    assert "[0]['a']['w']" in meta["keys"] and "[1]['step']" in meta["keys"]
    for (k, a), b in zip(tree_mod.flatten(t), tree_mod.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, _ck_tree(s), keep=3)
    assert ck.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004",
                                            "step_00000005"]
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_errors(tmp_path):
    ck.save(str(tmp_path), 1, _ck_tree())
    bad = _ck_tree()
    bad["a"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(str(tmp_path), 1, bad)
    more = _ck_tree()
    more["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        ck.restore(str(tmp_path), 1, more)


def _f32_pair(seed):
    rng = np.random.default_rng(seed)
    a = {"blocks": [{"attn": {"wq": rng.standard_normal((2, 4, 6))
                              .astype(np.float32)}}],
         "embed": rng.standard_normal((5, 4)).astype(np.float32)}
    s = {"m": {"embed": rng.standard_normal((5, 4)).astype(np.float32)},
         "step": np.int32(3)}
    return a, s


def test_checkpoint_restores_across_packages(tmp_path):
    """f32 trees written by either package restore in the other, with the
    reference's keys and array names."""
    a, s = _f32_pair(0)
    ref_ck.save(str(tmp_path / "ref"), 4, (jax.tree.map(jnp.asarray, a),
                                           jax.tree.map(jnp.asarray, s)))
    like = (tree_mod.map_leaves(torch.zeros_like, _torch(a)),
            {"m": {"embed": torch.zeros(5, 4)},
             "step": torch.zeros((), dtype=torch.int32)})
    got, meta = ck.restore(str(tmp_path / "ref"), 4, like)
    assert meta["keys"][0] == "[0]['blocks'][0]['attn']['wq']"
    for x, y in zip(tree_mod.leaves(got), jax.tree.leaves((a, s))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    ck.save(str(tmp_path / "port"), 4, (_torch(a), {
        "m": _torch(s["m"]), "step": torch.tensor(3, dtype=torch.int32)}))
    back, meta = ref_ck.restore(str(tmp_path / "port"), 4, jax.tree.map(
        jnp.zeros_like, (jax.tree.map(jnp.asarray, a),
                         jax.tree.map(jnp.asarray, s))))
    assert meta["step"] == 4
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves((a, s))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_tree_paths_are_jax_keystr():
    a, s = _f32_pair(1)
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path((a, s))[0]]
    assert [k for k, _ in tree_mod.flatten((a, s))] == want


# ---------------------------------------------------------------------------
# the modeled gradient-reduce schedule and the policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("tp_only", [False, True])
@pytest.mark.parametrize("arch", ["qwen3_4b", "llama4_scout_17b_a16e",
                                  "zamba2_2_7b"])
def test_grad_reduce_schedule_equals_reference(arch, overlap, tp_only):
    """Shapes of the published config, so leaf sizes span the cutovers;
    the leaves walk in JAX's order (the pipelined time depends on it)."""
    rc = ref_base.get_config(arch)
    shapes = jax.eval_shape(lambda: ref_model.init_params(jax.random.key(0),
                                                          rc))
    pt = jax.tree.map(lambda s: torch.empty(s.shape, dtype=getattr(
        torch, str(s.dtype)), device="meta"), shapes)
    rpol = dataclasses.replace(ref_policy.get(), overlap_grad_reduce=overlap,
                               param_tp_only=tp_only)
    ppol = dataclasses.replace(policy.get(), overlap_grad_reduce=overlap,
                               param_tp_only=tp_only)
    for npes in (4, 8):
        want = ref_ts.grad_reduce_schedule(
            shapes, ref_api.get_ops("shmem", npes=npes), policy=rpol)
        got = ts.grad_reduce_schedule(pt, api.get_ops("shmem", npes=npes),
                                      policy=ppol)
        assert got == want


def test_policy_overrides():
    pol = policy.parse_overrides(["attn_p_bf16=1", "attn_block_k=1024",
                                  "ce_chunk=128", "attn_impl=blockwise"])
    assert pol.attn_p_bf16 and pol.attn_block_k == 1024 and \
        pol.ce_chunk == 128
    # the fields only the sharding rules read are taken since the dry-run
    # was ported, and the three that change the model's compute since
    # they were ported too
    pol = policy.parse_overrides(["fsdp_gather_weights=1",
                                  "hidden_spec=dshard", "moe_expert_shard=1",
                                  "small_cache_bytes=4096"])
    assert pol.fsdp_gather_weights and pol.hidden_spec == "dshard" and \
        pol.moe_expert_shard and pol.small_cache_bytes == 4096
    pol = policy.parse_overrides(["attn_repeat_kv=1", "decode_onehot_update=1",
                                  "attn_impl=flash"])
    assert pol.attn_repeat_kv and pol.decode_onehot_update and \
        pol.attn_impl == "flash"
    ref_fields = set(ref_policy.PerfPolicy.__dataclass_fields__)
    assert set(policy.PerfPolicy.__dataclass_fields__) == ref_fields
    for name, f in policy.PerfPolicy.__dataclass_fields__.items():
        assert f.default == ref_policy.PerfPolicy.__dataclass_fields__[
            name].default


@pytest.mark.parametrize("knobs", [{}, {"attn_p_bf16": True},
                                   {"attn_qk_bf16": True},
                                   {"attn_block_q": 16, "attn_block_k": 32}])
def test_blockwise_attention_reads_the_policy(knobs):
    """``blockwise_causal_attn`` under each knob against the reference's
    under the same policy, f32 and bf16 inputs, with a window too."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention
    rng = np.random.default_rng(5)
    for dt in ("float32", "bfloat16"):
        q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
        jq, jk, jv = (jnp.asarray(a).astype(dt) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dt))
                      for a in (q, k, v))
        for window in (None, 24):
            with ref_policy.use(dataclasses.replace(ref_policy.get(),
                                                    **knobs)):
                want = ref_attn.blockwise_causal_attn(jq, jk, jv,
                                                      window=window)
            with policy.use(dataclasses.replace(policy.get(), **knobs)):
                got = attention.blockwise_causal_attn(tq, tk, tv,
                                                      window=window)
            tol = 2e-5 if dt == "float32" else 2e-2
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)


def test_train_mode_leaves_serving_paths_alone():
    """Prefill still returns the K2 path's logits, bitwise, whatever the
    policy's training knobs (the port's serving path reads none of them)."""
    pc = base.reduced(base.get_config("qwen3_4b"))
    pp = model.init_params(pc, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, pc.vocab_size, (1, 24)))
    a, _ = model.prefill(pp, pc, {"tokens": toks}, None)
    with policy.use(policy.PerfPolicy(attn_p_bf16=True, logits_bf16=True,
                                      ce_chunk=128, attn_block_q=8)):
        b, _ = model.prefill(pp, pc, {"tokens": toks}, None)
    assert torch.equal(a, b)
