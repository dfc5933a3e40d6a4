"""The recurrent blocks and their serving, held against the JAX package:
Mamba2, mLSTM and sLSTM (``models/ssm.py``), the pool layouts of zamba2 and
xlstm, and both families served disaggregated.

The same numpy inputs and the reference's weights (through the bridge) go
through ``repro.models.ssm`` and ``repro_torch.models.ssm``, at the reduced
widths (zamba2: d_model 256, 8 Mamba2 heads of 64, state 16; xlstm: 4
heads, mLSTM keys of 128).  Tolerances are the reference's: 2e-5 for f32
and 2e-2 for bf16 on one layer (``tests/test_kernels.py``); prompt lengths
64 and 128 chunk by 64, 40 by 40 and 1 by 1.  Layouts, heap words and
tokens are compared exactly.  Each family's disaggregated run is shared by
its tests through a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import context as ref_context, teams as ref_teams
from repro.models import model as ref_model, ssm as ref_ssm
from repro.models.layers import rms_norm as ref_rms_norm
from repro.serve import kvpool as ref_kvpool
from repro.serve.engine import Engine as RefEngine, \
    ServeConfig as RefServeConfig
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.core import context, teams
from repro_torch.models import kvcache, model, ssm
from repro_torch.models.layers import rms_norm
from repro_torch.serve import kvpool
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MAXLEN = 24
ARCHS = ("zamba2_2_7b", "xlstm_125m")


def _cfgs(arch, dtype="float32"):
    rc = ref_base.reduced(ref_base.get_config(arch))
    pc = base.reduced(base.get_config(arch))
    if dtype != "float32":
        rc = dataclasses.replace(rc, dtype=dtype, param_dtype=dtype)
        pc = dataclasses.replace(pc, dtype=dtype, param_dtype=dtype)
    return rc, pc


def _both(x, dtype):
    """numpy f32 -> (jax array, torch tensor) in ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                 dtype)))


def _t(a):
    return _bridge.array_to_torch(np.asarray(a), "cpu")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               _t(want).float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _same_dtype(got, want):
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name


def _block(init, arch, dtype, seed):
    """One block's reference weights and the same on the port's side."""
    rc, pc = _cfgs(arch, dtype)
    rp = init(jax.random.key(seed), rc, jnp.dtype(dtype))
    return rc, pc, rp, _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")


def _x(seed, B, S, d, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, S, d)) *
            scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the blocks, one layer at a time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,want", [(64, 64), (128, 64), (40, 40), (1, 1),
                                    (96, 48), (67, 1)])
def test_chunk_is_the_largest_divisor(s, want):
    assert ssm._chunk(s, ssm.MAMBA_CHUNK) == ref_ssm._chunk(s, 64) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 128, 40])
def test_mamba_forward_and_decode_match_reference(S, dtype):
    """The chunked SSD scan (chunk 64, or the whole of S = 40), its end
    state and conv window, then two decode steps from them; the conv
    window leaves prefill in the activation dtype and decode keeps it."""
    rc, pc, rp, pp = _block(ref_ssm.init_mamba, "zamba2_2_7b", dtype, S)
    jx, tx = _both(_x(S, 2, S, rc.d_model), dtype)
    ry, rstate, rconv = ref_ssm.mamba_forward(rp, jx, rc)
    py, pstate, pconv = ssm.mamba_forward(pp, tx, pc)
    for got, want in ((py, ry), (pstate, rstate), (pconv, rconv)):
        _same_dtype(got, want)
        _close(got, want, dtype)
    # decode from the cache leaves as the model holds them (f32)
    rstate_c, rconv_c = rstate, rconv.astype(jnp.float32)
    pstate_c, pconv_c = _t(rstate), _t(rconv_c)
    for step in range(2):
        jd, td = _both(_x(100 + step, 2, 1, rc.d_model), dtype)
        ry, rstate_c, rconv_c = ref_ssm.mamba_decode(rp, jd, rc, rstate_c,
                                                     rconv_c)
        py, pstate_c, pconv_c = ssm.mamba_decode(pp, td, pc, pstate_c,
                                                 pconv_c)
        for got, want in ((py, ry), (pstate_c, rstate_c),
                          (pconv_c, rconv_c)):
            _same_dtype(got, want)
            _close(got, want, dtype)


@pytest.mark.parametrize("S", [64, 40])
def test_mamba_forward_continues_from_a_state(S):
    """``mamba_forward`` with an initial state and a cached conv window
    (the reference's continuation form) in f32."""
    rc, pc, rp, pp = _block(ref_ssm.init_mamba, "zamba2_2_7b", "float32", 3)
    d_in, p, nh, N = ssm.mamba_dims(pc)
    rng = np.random.default_rng(S)
    state = rng.normal(size=(2, nh, p, N)).astype(np.float32)
    conv = rng.normal(size=(2, pc.ssm_conv - 1, d_in + 2 * N)).astype(
        np.float32)
    x = _x(S + 1, 2, S, rc.d_model)
    want = ref_ssm.mamba_forward(rp, jnp.asarray(x), rc, jnp.asarray(state),
                                 jnp.asarray(conv))
    got = ssm.mamba_forward(pp, torch.from_numpy(x), pc,
                            torch.from_numpy(state), torch.from_numpy(conv))
    for g, w in zip(got, want):
        _close(g, w, "float32")


def test_mamba_intra_chunk_decay_never_leaks_nan():
    """With dt_bias 3 every head decays by more than e^88 across a chunk of
    64, so exp(cs_l - cs_s) overflows to inf above the diagonal; the mask
    selects, so the output stays finite and equal to the reference's."""
    rc, pc, rp, pp = _block(ref_ssm.init_mamba, "zamba2_2_7b", "float32", 4)
    rp = dict(rp, dt_bias=jnp.full_like(rp["dt_bias"], 3.0))
    pp = dict(pp, dt_bias=torch.full_like(pp["dt_bias"], 3.0))
    x = _x(5, 1, 64, rc.d_model)
    dt = ssm._softplus(torch.from_numpy(x) @ pp["wdt"] + pp["dt_bias"])
    assert float((dt * torch.exp(pp["A_log"])).sum(1).min()) > 88.0
    ry, rs, _ = ref_ssm.mamba_forward(rp, jnp.asarray(x), rc)
    py, ps, _ = ssm.mamba_forward(pp, torch.from_numpy(x), pc)
    assert bool(py.isfinite().all()) and bool(ps.isfinite().all())
    _close(py, ry, "float32")
    _close(ps, rs, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 128, 40])
def test_mlstm_forward_and_decode_match_reference(S, dtype):
    """The chunked mLSTM (stabiliser m from -1e30), its (C, n, m), then two
    decode steps and a second forward chunk from that state."""
    rc, pc, rp, pp = _block(ref_ssm.init_mlstm, "xlstm_125m", dtype, S)
    jx, tx = _both(_x(S, 2, S, rc.d_model), dtype)
    ry, rst = ref_ssm.mlstm_forward(rp, jx, rc)
    py, pst = ssm.mlstm_forward(pp, tx, pc)
    _close(py, ry, dtype)
    for got, want in zip(pst, rst):
        _same_dtype(got, want)
        _close(got, want, dtype)
    pst = tuple(_t(s) for s in rst)
    for step in range(2):
        jd, td = _both(_x(200 + step, 2, 1, rc.d_model), dtype)
        ry, rst = ref_ssm.mlstm_decode(rp, jd, rc, rst)
        py, pst = ssm.mlstm_decode(pp, td, pc, pst)
        _close(py, ry, dtype)
        for got, want in zip(pst, rst):
            _close(got, want, dtype)
    jx, tx = _both(_x(S + 9, 2, 40, rc.d_model), dtype)
    py, pst = ssm.mlstm_forward(pp, tx, pc, tuple(_t(s) for s in rst))
    ry, rst = ref_ssm.mlstm_forward(rp, jx, rc, rst)
    _close(py, ry, dtype)
    for got, want in zip(pst, rst):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 17])
def test_slstm_forward_and_decode_match_reference(S, dtype):
    """The per-timestep sLSTM recurrence (c, n, m, h), its gelu-gated
    projection, then two decode steps from its state."""
    rc, pc, rp, pp = _block(ref_ssm.init_slstm, "xlstm_125m", dtype, S)
    jx, tx = _both(_x(S, 2, S, rc.d_model), dtype)
    ry, rst = ref_ssm.slstm_forward(rp, jx, rc)
    py, pst = ssm.slstm_forward(pp, tx, pc)
    _close(py, ry, dtype)
    for got, want in zip(pst, rst):
        _same_dtype(got, want)
        _close(got, want, dtype)
    pst = tuple(_t(s) for s in rst)
    for step in range(2):
        jd, td = _both(_x(300 + step, 2, 1, rc.d_model), dtype)
        ry, rst = ref_ssm.slstm_decode(rp, jd, rc, rst)
        py, pst = ssm.slstm_decode(pp, td, pc, pst)
        _close(py, ry, dtype)
        for got, want in zip(pst, rst):
            _close(got, want, dtype)


@pytest.mark.parametrize("kind,arch", [("mamba", "zamba2_2_7b"),
                                       ("mlstm", "xlstm_125m"),
                                       ("slstm", "xlstm_125m")])
def test_block_init_matches_reference_tree(kind, arch):
    """The port's stacked init has the reference's keys, per-layer shapes
    and dtypes, and its distributions (ones, zeros, 3.0 forget biases)."""
    for dtype in ("float32", "bfloat16"):
        rc, pc = _cfgs(arch, dtype)
        init = getattr(ref_ssm, f"init_{kind}")
        ref = init(jax.random.key(0), rc, jnp.dtype(dtype))
        port = getattr(ssm, f"init_{kind}")(
            torch.Generator().manual_seed(0), pc, getattr(torch, dtype),
            reps=3)
        assert sorted(port) == sorted(ref)
        for key, leaf in port.items():
            assert tuple(leaf.shape) == (3, *ref[key].shape), key
            _same_dtype(leaf, ref[key])
        for key in ("norm", "gnorm", "D", "f_bias", "bias", "A_log"):
            if key in port:
                np.testing.assert_array_equal(
                    port[key][1].float().numpy(),
                    np.asarray(ref[key], np.float32))


# ---------------------------------------------------------------------------
# the models: causality (tests/test_properties.py) and the pool layouts
# ---------------------------------------------------------------------------


def _logits_all(pc, pp, toks):
    """Every position's logits from the port's prefill-mode backbone."""
    x = model._embed(pp, pc, toks)
    B, S = toks.shape
    positions = torch.arange(S)[None].expand(B, S)
    x, _, _ = model.backbone(pp, pc, x, mode="prefill", positions=positions)
    return rms_norm(x, pp["final_norm"]) @ model._lm_matrix(pp, pc)


def _ref_logits_all(rc, rp, toks):
    x = ref_model._embed(rp, rc, toks)
    B, S = toks.shape
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    x, _, _ = ref_model.backbone(rp, rc, x, mode="train",
                                 positions=positions)
    return ref_rms_norm(x, rp["final_norm"]) @ ref_model._lm_matrix(rp, rc)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, reference cfg, port cfg, reference params, port params)."""
    rc, pc = _cfgs(request.param)
    rp = ref_model.init_params(jax.random.key(1), rc)
    return (request.param, rc, pc, rp,
            _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu"))


def test_causality_recurrent(family):
    """Changing tokens after position t never changes the logits at <= t
    (tests/test_properties.py::test_causality_recurrent), and every
    position's logits agree with the reference's within 2e-5."""
    arch, rc, pc, rp, pp = family
    S, t = 32, 12
    toks = np.random.default_rng(2).integers(0, pc.vocab_size, size=(1, S))
    toks2 = toks.copy()
    toks2[0, t + 1:] = 0
    la = _logits_all(pc, pp, torch.from_numpy(toks))
    lb = _logits_all(pc, pp, torch.from_numpy(toks2))
    np.testing.assert_allclose(la[0, :t + 1].numpy(), lb[0, :t + 1].numpy(),
                               atol=2e-4)
    assert not torch.allclose(la[0, t + 1:], lb[0, t + 1:])
    want = _ref_logits_all(rc, rp, jnp.asarray(toks, jnp.int32))
    _close(la, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_len,block_tokens", [(24, 8), (528, 16),
                                                  (21, 4)])
def test_layout_matches_reference(arch, max_len, block_tokens):
    """``build_layout`` leaf for leaf (tests/test_kvpool.py): zamba2 pages
    the shared block's K and V (one leaf each) and packs every Mamba2 state
    and conv window into the tail; xlstm is tail-only, with an f32 pool
    and one block a request."""
    rc, pc = _cfgs(arch, "bfloat16")
    want = ref_kvpool.build_layout(rc, max_len, block_tokens=block_tokens)
    got = kvpool.build_layout(pc, max_len, block_tokens=block_tokens)
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("paged", "tail"):
            assert [dataclasses.astuple(x) for x in g] == \
                [dataclasses.astuple(x) for x in w], f.name
        else:
            assert g == w, f.name
    for S in (1, 9, max_len):
        assert got.blocks_for_prompt(S) == want.blocks_for_prompt(S)
        assert got.blocks_for_decode(S, 5) == want.blocks_for_decode(S, 5)
    if arch == "zamba2_2_7b":
        assert [(x.unit_idx, x.key) for x in got.paged] == [(5, "k"),
                                                            (5, "v")]
        assert len(got.tail) == 10 and {t.key for t in got.tail} == \
            {"state", "conv"}
    else:
        assert not got.paged and got.kv_dtype == "float32"
        assert got.blocks_per_request == 1


def test_full_layouts_match_reference():
    """At the published widths (zamba2: blocks of 737,280 bf16 words and a
    tail of 15,454,080 f32 words at 528 tokens; xlstm: a tail of 3,566,616
    words) the layouts are the reference's, computed from shapes alone."""
    sizes = {}
    for arch in ARCHS:
        want = ref_kvpool.build_layout(ref_base.get_config(arch), 528)
        got = kvpool.build_layout(base.get_config(arch), 528)
        assert (got.block_words, got.tail_words, got.kv_dtype,
                got.blocks_per_request) == (want.block_words,
                                            want.tail_words, want.kv_dtype,
                                            want.blocks_per_request)
        sizes[arch] = (got.block_words, got.tail_words)
    assert sizes["zamba2_2_7b"] == (737_280, 15_454_080)
    assert sizes["xlstm_125m"][1] == 3_566_616


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_insert_roundtrip_bitwise(arch, dtype):
    """pack_blocks/pack_tail then insert_blocks/insert_tail reproduce the
    prefilled request bit for bit in another slot (tests/test_kvpool.py);
    at bf16 the conv window leaves prefill in bf16 and the tail's f32
    round trip keeps its bits."""
    rc, pc = _cfgs(arch, dtype)
    lay = kvpool.build_layout(pc, MAXLEN, block_tokens=8)
    pp = model.init_params(pc, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, pc.vocab_size, size=(1, 10)))
    _, c1 = model.prefill(pp, pc, {"tokens": toks},
                          kvcache.init_cache(pc, 1, MAXLEN, "cpu"))
    cB = kvcache.init_cache(pc, 4, MAXLEN, "cpu")
    cB = kvpool.insert_blocks(lay, cB, 2, kvpool.pack_blocks(lay, c1))
    cB = kvpool.insert_tail(lay, cB, 2, kvpool.pack_tail(lay, c1))
    for e1, eB in zip(c1["blocks"], cB["blocks"]):
        for key, leaf in e1.items():
            assert torch.equal(leaf[:, 0].to(eB[key].dtype), eB[key][:, 2])
            assert torch.equal(eB[key][:, 2].to(leaf.dtype), leaf[:, 0])


# ---------------------------------------------------------------------------
# disaggregated serving against the JAX scheduler (tests/test_disagg.py)
# ---------------------------------------------------------------------------


def _ref_run(arch, rp, prompts, NEW, fused=False):
    rc = ref_base.reduced(ref_base.get_config(arch))
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    reng = RefEngine(rc, rp, max_len=MAXLEN)
    rpool = ref_kvpool.KVPool.create(rheap, rc, MAXLEN, num_blocks=32,
                                     max_slots=3, block_tokens=8)
    pre, dec = ref_teams.disagg_partition(ref_teams.world(4), 2)
    rs = RefScheduler(rctx, rheap, reng, rpool, RefKVMigrator(rctx, rpool),
                      prefill_pes=pre.pes(), decode_pes=dec.pes(),
                      num_slots=3, scfg=RefServeConfig(max_new_tokens=NEW),
                      fused_attn=fused)
    for p in prompts:
        rs.submit({"tokens": jnp.asarray(p)})
    rs.run()
    return rs


def _port_run(arch, pp, prompts, NEW, fused=False):
    pc = base.reduced(base.get_config(arch))
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    eng = Engine(pc, pp, max_len=MAXLEN, device="cpu")
    pool = kvpool.KVPool.create(heap, pc, MAXLEN, num_blocks=32,
                                max_slots=3, block_tokens=8)
    pre, dec = teams.disagg_partition(teams.world(4), 2)
    ps = DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                         prefill_pes=pre.pes(), decode_pes=dec.pes(),
                         num_slots=3, scfg=ServeConfig(max_new_tokens=NEW),
                         fused_attn=fused)
    for p in prompts:
        ps.submit({"tokens": torch.from_numpy(p).long()})
    ps.run()
    return ps


@pytest.fixture(scope="module", params=[("zamba2_2_7b", False),
                                        ("zamba2_2_7b", True),
                                        ("xlstm_125m", False)],
                ids=["zamba2", "zamba2-fused", "xlstm"])
def disagg(request):
    """Both schedulers over the same weights and prompts: 3 requests of 10
    tokens, 5 new tokens each, 2 prefill + 2 decode PEs, 3 slots."""
    arch, fused = request.param
    rc = ref_base.reduced(ref_base.get_config(arch))
    rp = ref_model.init_params(jax.random.key(0), rc)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, rc.vocab_size, size=(1, 10)).astype(np.int32)
               for _ in range(3)]
    NEW = 5
    return (arch, prompts, NEW, _ref_run(arch, rp, prompts, NEW, fused),
            _port_run(arch, pp, prompts, NEW, fused))


def test_disagg_tokens_match_reference(disagg):
    """Every request's tokens equal the JAX scheduler's, and the port's
    single-PE baselines (``Engine.generate`` and the equal-shape slot
    path)."""
    arch, prompts, NEW, rs, ps = disagg
    for rid, req in ps.requests.items():
        assert req.out == [int(t) for t in rs.requests[rid].out], rid
        batch = {"tokens": torch.from_numpy(prompts[rid]).long()}
        assert ps.engine.generate(batch, ServeConfig(
            max_new_tokens=NEW))[0].tolist() == req.out
        assert ps.engine.generate_in_slot(
            batch, ServeConfig(max_new_tokens=NEW), num_slots=3,
            slot=req.slot) == req.out


def test_disagg_control_plane_matches_reference(disagg):
    """Counters, block tables, telemetry records and every int32 heap word
    (signals, headers) equal the reference's; the float pools (block
    payloads and the migrated tails) agree to the f32 tolerance."""
    arch, prompts, NEW, rs, ps = disagg
    for f in dataclasses.fields(ps.stats):
        assert getattr(rs.stats, f.name) == getattr(ps.stats, f.name), \
            f.name
    assert rs.pool.block_tables == ps.pool.block_tables == {}
    assert [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
            for r in rs.ctx.telemetry.trace] == \
        [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
         for r in ps.ctx.telemetry.trace]
    np.testing.assert_array_equal(ps.heap.pools["int32"].numpy(),
                                  np.asarray(rs.heap.pools["int32"]))
    for dt, pool in ps.heap.pools.items():
        if dt != "int32":
            np.testing.assert_allclose(
                pool.float().numpy(),
                np.asarray(rs.heap.pools[dt], np.float32), atol=5e-5,
                rtol=5e-5)
    st = ps.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (3, 3, 3, 3)
    assert st.bytes_migrated > ps.pool.layout.tail_words * 4 * 3
    assert len(ps.ctx.pending) == 0
