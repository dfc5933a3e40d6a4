"""The seven remaining configurations against the JAX package's, on the
reduced configs: minitron-8b and starcoder2-7b (dense; starcoder2's gelu
MLP), h2o-danube-3-4b (sliding window; at a 70-token prompt above its
reduced window of 64 the cache is a ring), llama4-scout and arctic (MoE,
top-1 with a shared expert and top-2 with a dense residual), whisper
(encoder-decoder over audio embeddings) and the vision model (gated
cross-attention over image embeddings, the gates set to 0.5 so they
count).  Their disaggregated serving is held in
``tests/test_torch_families_serve.py``.

Weights come from the reference's ``init_params`` through the bridge,
inputs from numpy seeds.  Tolerances are the reference's: 2e-5 for f32
and 2e-2 for a bf16 layer; a bf16 model's logits and cache leaves are held
by their relative L2 error within 6e-2, as ``tests/test_torch_model.py``
explains; tokens, heap words, tables and layouts exactly.  Each family's
reference run is made once, jitted, in a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.kernels import ishmem_device as ref_dev
from repro.models import attention as ref_attn, kvcache as ref_kvcache, \
    layers as ref_layers, model as ref_model, moe as ref_moe
from repro.serve import kvpool as ref_kvpool
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.models import attention, kvcache, layers, model, moe
from repro_torch.serve import kvpool
from _torch_threads import one_intra_op_thread  # noqa: F401

NEW_ARCHS = ("minitron_8b", "h2o_danube_3_4b", "starcoder2_7b",
             "llama4_scout_17b_a16e", "arctic_480b", "whisper_medium",
             "llama_3_2_vision_90b")
MOE = ("llama4_scout_17b_a16e", "arctic_480b")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_L2 = 6e-2
DECODE_STEPS = 5
# (arch, prompt length, cache length, dtype): every family in f32, danube
# also as a ring; bf16 where it takes paths of its own (the MoE's bf16
# products and combine, the encoder, the cross gate)
RUNS = [(a, 10, 24, "float32") for a in NEW_ARCHS] + [
    (a, 10, 24, "bfloat16") for a in ("llama4_scout_17b_a16e",
                                      "whisper_medium",
                                      "llama_3_2_vision_90b")] + [
    ("h2o_danube_3_4b", 70, 80, "float32")]


def _cfgs(arch, dtype="float32", **changes):
    rc = ref_base.reduced(ref_base.get_config(arch))
    pc = base.reduced(base.get_config(arch))
    if dtype != "float32":
        changes.update(dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(rc, **changes),
            dataclasses.replace(pc, **changes))


_REF_INIT = jax.jit(ref_model.init_params, static_argnums=1)
_REF_PREFILL = jax.jit(ref_model.prefill, static_argnums=1)
_REF_DECODE = jax.jit(ref_model.decode_step, static_argnums=1)
_REF_MOE = jax.jit(ref_moe.moe_ffn, static_argnums=2)
_REF_BLOCKWISE = jax.jit(ref_attn.blockwise_causal_attn,
                         static_argnames=("window", "block_q", "block_k"))


def _ref_params(rc, seed=0):
    rp = _REF_INIT(jax.random.key(seed), rc)
    for bp in rp["blocks"]:
        if "gate" in bp:
            bp["gate"] = jnp.full_like(bp["gate"], 0.5)
    return rp


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.int32:
        return torch.from_numpy(a.copy())
    return _bridge.array_to_torch(a, "cpu").float()


def _batch(cfg, B, S, seed):
    """(reference batch, port batch): tokens and the family's frontend
    embeddings, from one numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}
    n = {"audio": cfg.encoder_seq, "vlm": cfg.image_tokens}.get(cfg.family)
    if n:
        key = "audio_embeds" if cfg.family == "audio" else "image_embeds"
        e = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        rb[key], pb[key] = jnp.asarray(e), torch.from_numpy(e)
    return rb, pb


def _close(got, want, dtype, elementwise=False):
    got, ref = got.float().numpy(), _t(want).float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32" or elementwise:
        np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])
        return
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - ref) <= REL_L2 * np.linalg.norm(ref)


@pytest.fixture(scope="module", params=RUNS,
                ids=lambda p: f"{p[0]}-{p[1]}-{p[3]}")
def family_run(request):
    """Both packages' prefill and teacher-forced decode (fed the
    reference's greedy tokens) of one family: logits and caches."""
    arch, S, ML, dtype = request.param
    rc, pc = _cfgs(arch, dtype)
    rp = _ref_params(rc)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    B = 2
    rb, pb = _batch(pc, B, S, seed=S)
    rl, rcache = _REF_PREFILL(rp, rc, rb, ref_kvcache.init_cache(rc, B, ML))
    pl, pcache = model.prefill(pp, pc, pb, kvcache.init_cache(pc, B, ML,
                                                               "cpu"))
    out = {"dtype": dtype, "arch": arch, "ML": ML,
           "prefill": (pl, rl, pcache, rcache), "decode": []}
    pos = np.full((B,), S, np.int32)
    for _ in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
        rl, rcache = _REF_DECODE(rp, rc, jnp.asarray(tok)[:, None],
                                 jnp.asarray(pos), rcache)
        pl, pcache = model.decode_step(pp, pc,
                                       torch.from_numpy(tok).long()[:, None],
                                       torch.from_numpy(pos).long(), pcache)
        out["decode"].append((pl, rl))
        pos = pos + 1
    out["final"] = (pcache, rcache)
    return out


def _same_caches(pcache, rcache, dtype):
    assert len(pcache["blocks"]) == len(rcache["blocks"])
    for pentry, rentry in zip(pcache["blocks"], rcache["blocks"]):
        assert sorted(pentry) == sorted(rentry)
        for key, leaf in pentry.items():
            want = rentry[key]
            assert str(leaf.dtype).removeprefix("torch.") == \
                want.dtype.name, key
            if key == "kpos":
                assert torch.equal(leaf, _t(want)), key
            else:
                _close(leaf, want, dtype)


def test_prefill_logits_and_caches_match_reference(family_run):
    pl, rl, pcache, rcache = family_run["prefill"]
    assert pl.dtype == torch.float32
    _close(pl, rl, family_run["dtype"])
    _same_caches(pcache, rcache, family_run["dtype"])
    if family_run["ML"] > 64 and family_run["arch"] == "h2o_danube_3_4b":
        kpos = pcache["blocks"][0]["kpos"]            # 70 positions, W 64
        assert kpos.shape[-1] == 64 and int(kpos.max()) == 69


def test_teacher_forced_decode_matches_reference(family_run):
    for pl, rl in family_run["decode"]:
        _close(pl, rl, family_run["dtype"])
    _same_caches(*family_run["final"], family_run["dtype"])


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_base.ARCH_NAMES)
def test_config_and_reduced_match_reference(arch):
    """All ten names, in the reference's order; every field of the
    published and the reduced config, and the layer kinds."""
    assert base.ARCH_NAMES == ref_base.ARCH_NAMES
    full, ref_full = base.get_config(arch), ref_base.get_config(arch)
    assert base.get_config(full.name) is full
    rc, pc = _cfgs(arch)
    ref_names = [f.name for f in dataclasses.fields(rc)]
    assert [f.name for f in dataclasses.fields(pc)
            if f.name in ref_names] == ref_names
    for f in dataclasses.fields(pc):
        if f.name not in ref_names:            # the port's own: defaults
            assert getattr(full, f.name) == getattr(pc, f.name) == \
                f.default, f.name
            continue
        assert getattr(full, f.name) == getattr(ref_full, f.name), f.name
        assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert base.repeat_unit(full) == ref_base.repeat_unit(ref_full)
    assert base.layer_kinds(pc) == ref_base.layer_kinds(rc)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The port's own ``init_params`` gives the reference's tree (keys,
    shapes, dtypes: the f32 router and cross gates, the encoder's stacked
    blocks), and the bridge carries the reference's tree across
    unchanged; the weights keep the reference's distributions."""
    rc, pc = _cfgs(arch, "bfloat16")
    rp = _REF_INIT(jax.random.key(0), rc)
    ref_flat = {tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in kp): leaf
                for kp, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]}
    for tree in (model.init_params(pc, seed=1, device="cpu"),
                 _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")):
        flat = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, path + (i,))
            else:
                flat[path] = t
        walk(tree, ())
        assert sorted(flat, key=str) == sorted(ref_flat, key=str)
        for key, leaf in ref_flat.items():
            assert tuple(flat[key].shape) == leaf.shape, key
            assert str(flat[key].dtype).removeprefix("torch.") == \
                leaf.dtype.name, key
    port = model.init_params(pc, seed=1, device="cpu")
    blk = port["blocks"][0]
    attn = blk["attn"] if "attn" in blk else blk["cross"]
    assert abs(attn["wq"].float().std().item() * pc.d_model ** 0.5 - 1) < 0.05
    if arch in MOE:
        w = blk["moe"]["w_down"].float()
        assert abs(w.std().item() * pc.d_ff ** 0.5 - 1) < 0.05
        assert blk["moe"]["router"].dtype == torch.float32


def test_dense_init_draws_per_matrix_in_place():
    """A stacked weight is drawn one matrix at a time and keeps the
    reference's scale (fan_in = shape[-2])."""
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (3, 4, 256, 64), dtype=torch.bfloat16)
    assert w.shape == (3, 4, 256, 64) and w.dtype == torch.bfloat16
    assert abs(w.float().std().item() * 16 - 1) < 0.02
    assert not torch.equal(w[0, 0], w[0, 1])


# ---------------------------------------------------------------------------
# layers: gelu, the MoE, windowed attention
# ---------------------------------------------------------------------------


def test_gelu_is_jax_default_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(layers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() \
        > 1e-4                             # torch's default is the erf form


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    rc, pc = _cfgs("starcoder2_7b", dtype)
    rp = ref_layers.init_mlp(jax.random.key(1), rc.d_model, rc.d_ff, "gelu",
                             jnp.dtype(dtype))
    assert sorted(rp) == ["w_down", "w_up"]
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(2).normal(size=(3, 5, rc.d_model)).astype(
        np.float32)
    want = ref_layers.apply_mlp(rp, jnp.asarray(x, dtype), "gelu")
    got = layers.apply_mlp(pp, _t(jnp.asarray(x, dtype)).to(
        getattr(torch, dtype)), "gelu")
    _close(got, want, dtype, elementwise=True)


def _moe_case(arch, dtype, *, T, capacity_factor=None, skew=0.0, seed=0):
    changes = {} if capacity_factor is None else \
        {"capacity_factor": capacity_factor}
    rc, pc = _cfgs(arch, dtype, **changes)
    rp = ref_moe.init_moe(jax.random.key(seed), rc, jnp.dtype(dtype))
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(T, rc.d_model)).astype(np.float32)
    x += skew * rng.normal(size=(1, rc.d_model)).astype(np.float32)
    x /= np.sqrt(1.0 + skew ** 2)           # unit rms, as a normed input
    jx = jnp.asarray(x, dtype)
    return rc, pc, rp, pp, jx, _t(jx).to(getattr(torch, dtype))


def _drops(rc, rp, jx):
    """Routed assignments past capacity, by the reference's own routing."""
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ rp["router"], -1)
    _, idx = jax.lax.top_k(probs, rc.experts_per_token)
    load = np.bincount(np.asarray(idx).reshape(-1),
                       minlength=rc.num_experts)
    return int(np.maximum(load - ref_moe.capacity(rc, jx.shape[0]), 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [None, 8.0])
def test_moe_ffn_matches_reference(arch, dtype, capacity_factor):
    """``moe_ffn``'s (y, aux) at the reduced capacity, on skewed tokens so
    that some are dropped, and at capacity factor 8, where none is."""
    rc, pc, rp, pp, jx, tx = _moe_case(arch, dtype, T=48, skew=3.0,
                                       capacity_factor=capacity_factor)
    assert moe.capacity(pc, 48) == ref_moe.capacity(rc, 48)
    assert (_drops(rc, rp, jx) > 0) == (capacity_factor is None)
    ry, raux = _REF_MOE(rp, jx, rc)
    py, paux = moe.moe_ffn(pp, tx, pc)
    assert py.dtype == tx.dtype
    _close(py, ry, dtype, elementwise=True)
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ties_go_to_the_lower_expert(arch):
    """A zero router makes every expert's probability equal: both
    libraries route each token to experts 0..k-1."""
    rc, pc, rp, pp, jx, tx = _moe_case(arch, "float32", T=20)
    rp["router"] = jnp.zeros_like(rp["router"])
    pp["router"] = torch.zeros_like(pp["router"])
    ry, raux = _REF_MOE(rp, jx, rc)
    py, paux = moe.moe_ffn(pp, tx, pc)
    _close(py, ry, "float32", elementwise=True)
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-6)
    _, idx = torch.sort(torch.full((2, rc.num_experts), 0.25), dim=-1,
                        descending=True, stable=True)
    assert idx[:, :rc.experts_per_token].tolist() == \
        [list(range(rc.experts_per_token))] * 2


@pytest.mark.parametrize("S,window,block", [(160, 64, 32), (96, 64, 512),
                                            (130, 40, 26), (24, None, 8)])
def test_blockwise_causal_attn_matches_reference(S, window, block):
    """The windowed blockwise attention above the reduced window: KV
    blocks before the window skipped, keys at distance >= window masked;
    and the plain causal form."""
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 2, 64)).astype(np.float32)
            for _ in range(2))
    want = _REF_BLOCKWISE(*(jnp.asarray(a) for a in (q, k, v)),
                          window=window, block_q=block, block_k=block)
    got = attention.blockwise_causal_attn(
        *(torch.from_numpy(a) for a in (q, k, v)), window=window,
        block_q=block, block_k=block)
    _close(got, want, "float32")
    # against a full masked softmax
    qp = np.arange(S)[:, None]
    kp = np.arange(S)[None, :]
    mask = (kp <= qp) & ((kp > qp - window) if window else True)
    full = attention.full_attn(*(torch.from_numpy(a) for a in (q, k, v)),
                               mask=torch.from_numpy(mask)[None, None, None])
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a not in MOE])
def test_decode_matches_full_forward(arch):
    """decode(prefill(S), token S) == prefill(S+1)'s last logits
    (``tests/test_models_smoke.py``), the port alone."""
    _, pc = _cfgs(arch)
    pp = model.init_params(pc, seed=2, device="cpu")
    _check_decode_law(pc, pp)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_full_forward_at_high_capacity(arch):
    """The same law for the MoE families at capacity factor 8, where no
    batch size drops a token."""
    _, pc = _cfgs(arch, capacity_factor=8.0)
    _check_decode_law(pc, model.init_params(pc, seed=3, device="cpu"))


def _check_decode_law(pc, pp):
    B, S = 2, 24
    _, batch = _batch(pc, B, S + 1, seed=4)
    short = dict(batch, tokens=batch["tokens"][:, :S])
    _, cache = model.prefill(pp, pc, short, kvcache.init_cache(pc, B, S + 1,
                                                               "cpu"))
    lg_dec, _ = model.decode_step(pp, pc, batch["tokens"][:, S:S + 1],
                                  torch.full((B,), S), cache)
    lg_full, _ = model.prefill(pp, pc, batch, kvcache.init_cache(
        pc, B, S + 1, "cpu"))
    assert float((lg_dec - lg_full).abs().max()) < 2e-4


def test_swa_matches_full_when_window_covers():
    """A window at least as long as the sequence (the blockwise branch)
    gives full causal attention's logits (the K2 branch)."""
    _, pc = _cfgs("h2o_danube_3_4b", window=4096)
    pp = model.init_params(pc, seed=4, device="cpu")
    _, batch = _batch(pc, 2, 48, seed=5)
    full = dataclasses.replace(pc, attention="full")
    l1, _ = model.prefill(pp, pc, batch, None)
    l2, _ = model.prefill(pp, full, batch, None)
    assert float((l1 - l2).abs().max()) < 1e-4


def test_ring_decode_reads_only_the_window():
    """At the reduced window of 64, decode far past it equals a dense
    cache's decode with the keys outside the window masked: the ring's
    ``kpos`` validity, slot ``pos % W``."""
    _, pc = _cfgs("h2o_danube_3_4b")
    pp = model.init_params(pc, seed=6, device="cpu")
    B, S, steps = 1, 100, 4
    _, batch = _batch(pc, B, S + steps, seed=7)
    ring = kvcache.init_cache(pc, B, S + steps, "cpu")
    assert ring["blocks"][0]["kpos"].shape == (2, B, 64)
    assert bool((ring["blocks"][0]["kpos"] == -1).all())
    _, ring = model.prefill(pp, pc, dict(batch, tokens=batch["tokens"][:,
                                                                       :S]),
                            ring)
    for t in range(steps):
        lg, ring = model.decode_step(pp, pc, batch["tokens"][:, S + t:S + t +
                                                             1],
                                     torch.full((B,), S + t), ring)
        want, _ = model.prefill(pp, pc, dict(
            batch, tokens=batch["tokens"][:, :S + t + 1]), None)
        np.testing.assert_allclose(lg.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
    assert int(ring["blocks"][0]["kpos"].max()) == S + steps - 1


# ---------------------------------------------------------------------------
# layouts and lossless packing
# ---------------------------------------------------------------------------


def _layout_fields(lay):
    d = dataclasses.asdict(lay)
    d["paged"] = [tuple(p.values()) for p in d["paged"]]
    d["tail"] = [tuple(t.values()) for t in d["tail"]]
    return d


@pytest.mark.parametrize("max_len", [24, 100])
@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_layout_matches_reference(arch, max_len, dtype):
    """Every field, leaf for leaf, and each paged leaf's word offset in a
    block, where its view of a block lies; above the reduced window
    danube's layout is a ring whose tail is its int32 ``kpos``, and a ring
    needs all its blocks whatever the prompt."""
    rc, pc = _cfgs(arch, dtype)
    lay = kvpool.build_layout(pc, max_len, block_tokens=8)
    rlay = ref_kvpool.build_layout(rc, max_len, block_tokens=8)
    assert _layout_fields(lay) == _layout_fields(rlay)
    assert lay.leaf_offsets == ref_dev._leaf_offsets(rlay)
    assert lay.paged_keys == set(ref_dev._leaf_offsets(rlay))
    words = torch.arange(lay.block_words)
    for pl in lay.paged:
        off = lay.leaf_offsets[pl.path]
        view = lay.leaf_view(words, pl)
        T = lay.block_tokens
        assert view.shape == (pl.reps, T, pl.nkv, pl.hd)
        assert torch.equal(view.reshape(-1), torch.arange(
            off, off + pl.words_per_token * T))
    for S, new in ((5, 1), (20, 4), (max_len - 4, 4)):
        assert lay.blocks_for_prompt(S) == rlay.blocks_for_prompt(S)
        assert lay.blocks_for_decode(S, new) == rlay.blocks_for_decode(S, new)
    assert lay.ring == (arch == "h2o_danube_3_4b" and max_len > 64)
    if lay.ring:
        assert [(t.key, t.dtype) for t in lay.tail] == [("kpos", "int32")]
        assert lay.blocks_for_prompt(5) == lay.blocks_for_decode(5, 90) == 8


@pytest.mark.parametrize("arch,max_len,S,dtype", [
    (a, 24, 10, "float32") for a in NEW_ARCHS] + [
    (a, 24, 10, "bfloat16") for a in ("whisper_medium",
                                      "llama_3_2_vision_90b")] + [
    ("h2o_danube_3_4b", 100, S, dt) for S in (40, 90)
    for dt in ("float32", "bfloat16")])
def test_pack_insert_roundtrip_bitwise(arch, max_len, S, dtype):
    """pack_blocks / pack_tail then insert_blocks / insert_tail give the
    prefilled request back bit for bit in another slot of a larger cache
    (``tests/test_kvpool.py``), a ring's ``kpos`` included: at S = 40 its
    empty slots hold -1, a NaN bit pattern in the f32 tail; at S = 90 it
    wraps."""
    _, pc = _cfgs(arch, dtype)
    lay = kvpool.build_layout(pc, max_len, block_tokens=8)
    pp = model.init_params(pc, seed=8, device="cpu")
    _, batch = _batch(pc, 1, S, seed=9)
    _, c1 = model.prefill(pp, pc, batch, kvcache.init_cache(pc, 1, max_len,
                                                            "cpu"))
    tail = kvpool.pack_tail(lay, c1)
    assert tail.dtype == torch.float32 and tail.numel() == lay.tail_words
    if lay.ring:
        kpos = c1["blocks"][0]["kpos"]
        assert bool((kpos == -1).any()) == (S < 64)
        assert int(kpos.max()) == S - 1
        assert bool(tail.isnan().any()) == (S < 64)
    cB = kvcache.init_cache(pc, 4, max_len, "cpu")
    cB = kvpool.insert_blocks(lay, cB, 2, kvpool.pack_blocks(lay, c1))
    cB = kvpool.insert_tail(lay, cB, 2, tail)
    for e1, eB in zip(c1["blocks"], cB["blocks"]):
        assert sorted(e1) == sorted(eB)
        for key in e1:
            assert torch.equal(e1[key][:, 0], eB[key][:, 2]), key
