"""The device-initiated work-group layer, fused per-block admission, ring
attention and the tile reduction, held against the JAX package.

The same numpy inputs go through ``repro.*`` (its Pallas kernels in
interpret mode, as ``tests/test_device.py`` and ``tests/test_kernels.py``
run them) and ``repro_torch.*`` (each kernel's plain version on the CPU).
Data movement and control are compared exactly: heap bytes, signal words,
block tables, telemetry records (modeled seconds equal as floats) and
greedy tokens.  Float compute is compared to the reference's own
tolerances: 2e-5 for a flash partial in f32, 5e-5 / 1e-5 for merged ring
attention, 5e-5 for payloads that came from an f32 prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihyp import given, settings, strategies as st

from repro.configs import base as ref_base
from repro.core import context as ref_context, cutover as ref_cutover, \
    device as ref_device
from repro.kernels import ops as ref_ops, ref as ref_oracles
from repro.models import model as ref_model
from repro.serve.engine import Engine as RefEngine, \
    ServeConfig as RefServeConfig
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.core import context, cutover, device
from repro_torch.kernels import flash_attn, ishmem_device, ops, \
    reduce_tile as rt
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import EXTRA_SIGNALS, KVMigrator, \
    fused_admit_signal
from repro_torch.serve.paged_attn import PagedDecodeView
from repro_torch.serve.scheduler import DisaggScheduler
from _torch_threads import one_intra_op_thread  # noqa: F401

MAXLEN = 24
TOL = 5e-5                 # payloads and logits from an f32 prefill


@pytest.fixture
def counts():
    ops.reset_launches()
    yield ops.LAUNCHES
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}, \
        "a CPU tensor launched a kernel"


def _records(ctx):
    return [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
            for r in ctx.telemetry.trace]


def _same_heap(rheap, pheap):
    """Every pool of both heaps, byte for byte (bf16 through f32)."""
    assert sorted(rheap.pools) == sorted(pheap.pools)
    for dt, pool in pheap.pools.items():
        want = np.asarray(jnp.asarray(rheap.pools[dt]).astype(
            jnp.float32 if dt == "bfloat16" else dt))
        got = (pool.float() if dt == "bfloat16" else pool).numpy()
        np.testing.assert_array_equal(got, want, err_msg=dt)


def _pair(npes=4):
    rctx, rheap = ref_context.init(npes=npes, node_size=npes)
    ctx, heap = context.init(npes=npes, node_size=npes, device="cpu")
    return rctx, rheap, ctx, heap


def _malloc(rheap, heap, shape, dtype):
    rptr = rheap.malloc(shape, getattr(jnp, dtype))
    ptr = heap.malloc(shape, getattr(torch, dtype))
    assert (rptr.offset, rptr.shape) == (ptr.offset, ptr.shape)
    return rptr, ptr


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# 1. work-group op semantics (tests/test_device.py §1)
# ---------------------------------------------------------------------------


def test_put_get_roundtrip_records_width(counts):
    rctx, rheap, ctx, heap = _pair()
    rwg = ref_device.work_group(rctx, size=64, pe=0)
    wg = device.work_group(ctx, size=64, pe=0)
    rbuf, buf = _malloc(rheap, heap, (128,), "float32")
    rval, val = _both(np.arange(128, dtype=np.float32))
    rheap = ref_device.put(rwg, rheap, rbuf, rval, 2)
    heap = device.put(wg, heap, buf, val, 2)
    _same_heap(rheap, heap)
    assert torch.equal(heap.read(buf, 2), val)
    assert not heap.read(buf, 0).any()
    got = device.get(wg, heap, buf, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_device.get(rwg, rheap, rbuf, 2)))
    recs = [r for r in ctx.ledger if r.op in ("device_put", "device_get")]
    assert len(recs) == 2
    assert {r.work_items for r in recs} == {64}
    assert {r.tier for r in recs} == {"ici"}
    assert _records(ctx) == _records(rctx)


def test_work_group_width_follows_tuning():
    rctx, _, ctx, _ = _pair(2)
    assert device.work_group(ctx).size == ctx.tuning.work_group_size
    assert device.work_group(ctx).size == \
        ref_device.work_group(rctx).size
    assert device.work_group(ctx, size=32).size == 32
    wg = device.work_group(ctx, size=32, pe=1)
    assert (wg.tier(0), wg.pid, wg.tid) == ("ici", "pod0", "pe1")


def test_put_signal_nbi_defers_until_device_wait(counts):
    rctx, rheap, ctx, heap = _pair()
    rwg = ref_device.work_group(rctx, size=128, pe=0)
    wg = device.work_group(ctx, size=128, pe=0)
    rbuf, buf = _malloc(rheap, heap, (64,), "float32")
    rsig, sig = _malloc(rheap, heap, (1,), "int32")
    rone, one = _both(np.ones(64, np.float32))
    rheap = ref_device.put_signal_nbi(rwg, rheap, rbuf, rone, rsig, 1,
                                      ref_device.SIGNAL_ADD, 1)
    heap = device.put_signal_nbi(wg, heap, buf, one, sig, 1,
                                 device.SIGNAL_ADD, 1)
    # parked: neither data nor flag visible before the completion point
    _same_heap(rheap, heap)
    assert not heap.read(buf, 1).any() and int(heap.read(sig, 1)) == 0
    rheap, rcur, rok = ref_device.signal_wait_until(rwg, rheap, rsig, 1,
                                                    "ge", 1)
    heap, cur, ok = device.signal_wait_until(wg, heap, sig, 1, "ge", 1)
    assert (ok, int(cur)) == (bool(rok), int(rcur)) == (True, 1)
    _same_heap(rheap, heap)
    assert bool((heap.read(buf, 1) == 1.0).all())
    assert len(ctx.pending) == len(rctx.pending) == 0
    assert _records(ctx) == _records(rctx)


def test_signal_wait_forces_minimal_prefix(counts):
    """The device wait completes exactly the queue prefix through the
    first op that can advance the waited word — later traffic stays
    pending, on both packages alike."""
    rctx, rheap, ctx, heap = _pair()
    rwg = ref_device.work_group(rctx, size=128, pe=0)
    wg = device.work_group(ctx, size=128, pe=0)
    ptrs = [_malloc(rheap, heap, (32,), "float32") for _ in range(3)]
    rsig, sig = _malloc(rheap, heap, (1,), "int32")
    for (rp, p), fill in zip(ptrs[:2], (1.0, 2.0)):
        rv, v = _both(np.full(32, fill, np.float32))
        rheap = ref_device.put_signal_nbi(rwg, rheap, rp, rv, rsig, 1,
                                          ref_device.SIGNAL_ADD, 1)
        heap = device.put_signal_nbi(wg, heap, p, v, sig, 1,
                                     device.SIGNAL_ADD, 1)
    rv, v = _both(np.full(32, 3.0, np.float32))
    rheap = ref_device.put_nbi(rwg, rheap, ptrs[2][0], rv, 1)
    heap = device.put_nbi(wg, heap, ptrs[2][1], v, 1)
    for target, landed in ((1, (1.0, 0.0, 0.0)), (2, (1.0, 2.0, 0.0))):
        rheap, rcur, rok = ref_device.signal_wait_until(rwg, rheap, rsig,
                                                        1, "ge", target)
        heap, cur, ok = device.signal_wait_until(wg, heap, sig, 1, "ge",
                                                 target)
        assert (ok, int(cur)) == (bool(rok), int(rcur)) == (True, target)
        for (_, p), want in zip(ptrs, landed):
            assert bool((heap.read(p, 1) == want).all())
        assert len(ctx.pending) == len(rctx.pending) > 0
        _same_heap(rheap, heap)
    assert _records(ctx) == _records(rctx)


def test_signal_wait_unsatisfiable_reports_not_ok(counts):
    rctx, rheap, ctx, heap = _pair()
    rwg = ref_device.work_group(rctx, size=128, pe=0)
    wg = device.work_group(ctx, size=128, pe=0)
    rsig, sig = _malloc(rheap, heap, (1,), "int32")
    rother, other = _malloc(rheap, heap, (32,), "float32")
    # nothing pending at all
    rheap, rcur, rok = ref_device.signal_wait_until(rwg, rheap, rsig, 1,
                                                    "ge", 1)
    heap, cur, ok = device.signal_wait_until(wg, heap, sig, 1, "ge", 1)
    assert (ok, int(cur)) == (bool(rok), int(rcur)) == (False, 0)
    # pending traffic that can never advance the waited word
    rv, v = _both(np.ones(32, np.float32))
    rheap = ref_device.put_nbi(rwg, rheap, rother, rv, 1)
    heap = device.put_nbi(wg, heap, other, v, 1)
    rheap, _, rok = ref_device.signal_wait_until(rwg, rheap, rsig, 1, "ge", 1)
    heap, _, ok = device.signal_wait_until(wg, heap, sig, 1, "ge", 1)
    assert ok is False and not rok
    assert len(ctx.pending) == len(rctx.pending) == 1   # untouched
    _same_heap(rheap, heap)
    assert _records(ctx) == _records(rctx)


def test_broadcast_reduce_values_and_telemetry(counts):
    rctx, rheap, ctx, heap = _pair()
    rwg = ref_device.work_group(rctx, size=256, pe=0)
    wg = device.work_group(ctx, size=256, pe=0)
    rbuf, buf = _malloc(rheap, heap, (16,), "float32")
    rv, v = _both(np.arange(16, dtype=np.float32))
    rheap = rheap.write(rbuf, 1, rv)
    heap = heap.write(buf, 1, v)
    rheap = ref_device.broadcast(rwg, rheap, rbuf, 1, rctx.team_world)
    heap = device.broadcast(wg, heap, buf, 1, ctx.team_world)
    for pe in range(4):
        assert torch.equal(heap.read(buf, pe), v)
    rdest, dest = _malloc(rheap, heap, (16,), "float32")
    rheap = ref_device.reduce(rwg, rheap, rdest, rbuf, "sum",
                              rctx.team_world)
    heap = device.reduce(wg, heap, dest, buf, "sum", ctx.team_world)
    assert torch.equal(heap.read(dest, 2), 4.0 * v)
    assert {"device_broadcast", "device_reduce"} <= {r.op for r in ctx.ledger}
    _same_heap(rheap, heap)
    assert _records(ctx) == _records(rctx)


# ---------------------------------------------------------------------------
# 2. fused migration vs the pending-queue oracle, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    return ref_model.init_params(jax.random.key(0), cfg)


@pytest.fixture(scope="module")
def params(ref_params):
    return _bridge.to_torch(jax.tree.map(np.asarray, ref_params), "cpu")


@pytest.fixture(scope="module")
def engines(ref_params, params):
    rcfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    cfg = base.reduced(base.get_config("qwen3-4b"))
    return (rcfg, RefEngine(rcfg, ref_params, max_len=MAXLEN),
            cfg, Engine(cfg, params, max_len=MAXLEN, device="cpu"))


def _pools(engines, *, npes=4, num_blocks=32, max_slots=3, block_tokens=4):
    rcfg, _, cfg, _ = engines
    rctx, rheap, ctx, heap = _pair(npes)
    rpool = RefKVPool.create(rheap, rcfg, MAXLEN, num_blocks=num_blocks,
                             max_slots=max_slots, block_tokens=block_tokens)
    pool = KVPool.create(heap, cfg, MAXLEN, num_blocks=num_blocks,
                         max_slots=max_slots, block_tokens=block_tokens)
    return rctx, rheap, rpool, ctx, heap, pool


def _close_heap(rheap, heap):
    """int32 words exact, f32 payloads to the prefill tolerance."""
    np.testing.assert_array_equal(heap.pools["int32"].numpy(),
                                  np.asarray(rheap.pools["int32"]))
    np.testing.assert_allclose(heap.pools["float32"].numpy(),
                               np.asarray(rheap.pools["float32"]),
                               atol=TOL, rtol=TOL)


@settings(max_examples=8, deadline=None)
@given(st.integers(6, 20))
def test_fused_blocks_invisible_until_their_signal(engines, S):
    """After ``migrate_fused`` block k reads zero decode-side until the wait
    for ``sig >= EXTRA + k`` completes, admission consumes only the first
    block — and both packages agree at every step."""
    _, reng, _, eng = engines
    rctx, rheap, rpool, ctx, heap, pool = _pools(engines, max_slots=1)
    rmig, mig = RefKVMigrator(rctx, rpool), KVMigrator(ctx, pool)
    p = np.random.default_rng(S).integers(0, 512, (1, S)).astype(np.int32)
    rtok, _, rc = reng.prefill_request({"tokens": jnp.asarray(p)},
                                       jax.random.key(3))
    tok, _, c = eng.prefill_request({"tokens": torch.from_numpy(p).long()})
    assert tok == int(rtok)
    rheap, rids = rmig.stage(rheap, 0, rc, prompt_len=S, src_pe=0)
    heap, ids = mig.stage(heap, 0, c, prompt_len=S, src_pe=0)
    assert ids == rids
    rheap, rrep = rmig.migrate_fused(rheap, 0, src_pe=0, dst_pe=1, slot=0,
                                     prompt_len=S, first_token=rtok)
    heap, rep = mig.migrate_fused(heap, 0, src_pe=0, dst_pe=1, slot=0,
                                  prompt_len=S, first_token=tok)
    assert dataclasses.asdict(rep) == {
        k: v for k, v in dataclasses.asdict(rrep).items()
        if k in dataclasses.asdict(rep)}
    assert rep.fused and rep.n_wire == len(ids)
    assert rep.expected_signal == len(ids) + EXTRA_SIGNALS
    for bid in ids:                       # everything still on the queue
        assert not heap.read(pool.block_ptr(bid), 1).any()
    _close_heap(rheap, heap)
    rheap, rhdr, rres = rmig.try_admit_fused(rheap, 0, 1, rrep.n_wire)
    heap, hdr, resident = mig.try_admit_fused(heap, 0, 1, rep.n_wire)
    assert hdr == rhdr == {"req_id": 0, "prompt_len": S, "first_token": tok,
                           "n_blocks": len(ids)}
    assert resident == rres == min(1, rep.n_wire)
    sig = pool.sig_ptr(0)
    assert int(heap.read(sig, 1)) == fused_admit_signal(rep.n_wire)
    have = resident
    while have < len(ids):
        for bid in ids[have:]:            # unconsumed blocks stay invisible
            assert not heap.read(pool.block_ptr(bid), 1).any()
        _close_heap(rheap, heap)
        rheap, rhave = rmig.consume_blocks(rheap, 0, 1, have, have + 1)
        heap, have = mig.consume_blocks(heap, 0, 1, have, have + 1)
        assert have == rhave
        assert int(heap.read(sig, 1)) == EXTRA_SIGNALS + have
        for bid in ids[:have]:            # consumed blocks match the source
            assert torch.equal(heap.read(pool.block_ptr(bid), 1),
                               heap.read(pool.block_ptr(bid), 0))
    assert len(ctx.pending) == len(rctx.pending) == 0
    _close_heap(rheap, heap)
    assert _records(ctx) == _records(rctx)


# ---------------------------------------------------------------------------
# 3. fused paged attention and the fused scheduler
# ---------------------------------------------------------------------------


def _prompts(n, S=10):
    """tests/test_device.py::_prompt for keys 0..n-1, as numpy."""
    return [np.asarray(jax.random.randint(jax.random.key(i), (1, S), 0, 512))
            for i in range(n)]


def _scheds(engines, *, num_slots=2, NEW=5, decode_pes=(2, 3), **kw):
    """The same scheduler on both packages (tests/test_device.py::_sched)."""
    _, reng, _, eng = engines
    rctx, rheap, rpool, ctx, heap, pool = _pools(engines)
    rs = RefScheduler(rctx, rheap, reng, rpool, RefKVMigrator(rctx, rpool),
                      prefill_pes=[0, 1], decode_pes=list(decode_pes),
                      num_slots=num_slots,
                      scfg=RefServeConfig(max_new_tokens=NEW), **kw)
    ps = DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                         prefill_pes=[0, 1], decode_pes=list(decode_pes),
                         num_slots=num_slots,
                         scfg=ServeConfig(max_new_tokens=NEW), **kw)
    return rs, ps


def _lockstep(rs, ps):
    """Step both schedulers until done; the control plane must agree after
    every step."""
    steps = 0
    while not (rs.done() and ps.done()):
        rs.step()
        ps.step()
        steps += 1
        assert steps < 200
        assert [(r.rid, r.state, r.slot, r.decode_pe, r.fused_pending,
                 r.first_block_step) for r in rs.requests.values()] == \
            [(r.rid, r.state, r.slot, r.decode_pe, r.fused_pending,
              r.first_block_step) for r in ps.requests.values()]
        assert rs.pool.block_tables == ps.pool.block_tables
        _close_heap(rs.heap, ps.heap)
    return steps


def test_fused_paged_attn_bitwise_vs_assemble(engines, counts):
    """Device-gathered K/V through the slot tables feeds K2 and reproduces
    ``assemble``'s leaves bit for bit; the port's output agrees with the
    reference's on the same scheduler state."""
    rs, ps = _scheds(engines, decode_pes=[2], fused_attn=True)
    (p,) = _prompts(1)
    rs.submit({"tokens": jnp.asarray(p)})
    ps.submit({"tokens": torch.from_numpy(p).long()})
    guard = 0
    while not ps.stats.admissions and guard < 50:
        rs.step()
        ps.step()
        guard += 1
    rs.step()
    ps.step()                             # one decode: all blocks consumed
    assert rs.stats.admissions == ps.stats.admissions == 1
    view, rview = ps.views[2], rs.views[2]
    lay = ps.pool.layout
    assert lay.paged
    assembled = view.assemble(ps.heap, ps.banks[2].cache)
    wg = device.work_group(ps.ctx, size=128, pe=2)
    rwg = ref_device.work_group(rs.ctx, size=128, pe=2)
    waits, rwaits = [(ps.pool.sig_ptr(0), EXTRA_SIGNALS)], \
        [(rs.pool.sig_ptr(0), EXTRA_SIGNALS)]
    for unit in sorted({leaf.unit_idx for leaf in lay.paged}):
        k_leaf = next(leaf for leaf in lay.paged
                      if leaf.unit_idx == unit and leaf.key == "k")
        qn = np.random.default_rng(11 + unit).normal(
            size=(view.num_slots, k_leaf.width, k_leaf.nkv, k_leaf.hd)
        ).astype(np.float32)
        heap2, out = ishmem_device.fused_paged_attn(
            wg, ps.heap, view, torch.from_numpy(qn), unit_idx=unit,
            waits=waits)
        k_ref = assembled["blocks"][unit]["k"][0].contiguous()
        v_ref = assembled["blocks"][unit]["v"][0].contiguous()
        ref = flash_attn.flash_attention(torch.from_numpy(qn), k_ref, v_ref)
        assert torch.equal(out, ref)
        _, rout = ref_ops.fused_paged_attn(rwg, rs.heap, rview,
                                           jnp.asarray(qn), unit_idx=unit,
                                           waits=rwaits)
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=TOL,
                                   rtol=TOL)
    assert _records(ps.ctx) == _records(rs.ctx)
    ps.run()
    rs.run()
    assert [r.out for r in ps.requests.values()] == \
        [r.out for r in rs.requests.values()]


def test_fused_paged_attn_refuses_unsatisfiable_wait(engines, counts):
    """A wait no pending traffic can satisfy raises before any block byte
    is read: no device_get is recorded."""
    *_, ctx, heap, pool = _pools(engines)
    view = PagedDecodeView(pool, pe=1, num_slots=1)
    wg = device.work_group(ctx, size=128, pe=1)
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(RuntimeError, match="never satisfy"):
        ishmem_device.fused_paged_attn(wg, heap, view, q,
                                       waits=[(pool.sig_ptr(0), 5)])
    assert [r.op for r in ctx.ledger] == ["device_signal_wait"]


def test_fused_scheduler_bitwise_and_first_block_stat(engines, counts):
    """fused_attn=True reproduces the barrier mode's decode streams and the
    single-PE baseline exactly, with a strictly earlier mean first-block
    step — and steps exactly like the reference's fused scheduler: states,
    block tables, int32 signal words, first-block steps, telemetry and
    tokens."""
    prompts = _prompts(4)
    outs, stats = {}, {}
    for fused in (False, True):
        rs, ps = _scheds(engines, admit_delay_steps=2, fused_attn=fused)
        for p in prompts:
            rs.submit({"tokens": jnp.asarray(p)})
            ps.submit({"tokens": torch.from_numpy(p).long()})
        _lockstep(rs, ps)
        for rid, r in rs.requests.items():
            assert r.out == ps.requests[rid].out
        assert rs.stats.ttfd_first_block_steps == \
            ps.stats.ttfd_first_block_steps
        for f in dataclasses.fields(ps.stats):
            assert getattr(rs.stats, f.name) == getattr(ps.stats, f.name), \
                f.name
        assert _records(ps.ctx) == _records(rs.ctx)
        outs[fused] = [ps.requests[i].out for i in range(4)]
        stats[fused] = ps
    s_f = stats[True]
    eng = s_f.engine
    assert outs[True] == outs[False]
    for i, p in enumerate(prompts):
        base_out = eng.generate({"tokens": torch.from_numpy(p).long()},
                                ServeConfig(max_new_tokens=5))
        assert base_out[0].tolist() == outs[True][i]
    assert len(s_f.stats.ttfd_first_block_steps) == 4
    assert np.mean(s_f.stats.ttfd_first_block_steps) < \
        np.mean(stats[False].stats.ttfd_first_block_steps)
    for req in s_f.requests.values():
        assert 0 <= req.first_block_step <= req.admit_step
    assert len(s_f.ctx.pending) == 0


def test_fused_attn_requires_paged_and_no_streaming(engines):
    *_, ctx, heap, pool = _pools(engines)
    eng = engines[3]
    for kw, match in (({"paged": False}, "paged"),
                      ({"stream_chunks": 1}, "stream")):
        with pytest.raises(ValueError, match=match):
            DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                            prefill_pes=[0, 1], decode_pes=[2, 3],
                            num_slots=2, fused_attn=True, **kw)


# ---------------------------------------------------------------------------
# 4. K10 and ring attention against the Pallas flash_partial
# ---------------------------------------------------------------------------


def _qkv(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("npes", [2, 4])
def test_ring_attention_matches_flash(npes, counts):
    """Against the port's K2 and the reference's causal oracle
    (``kernels/ref.py``); the partials themselves are held against the
    Pallas ``flash_partial`` below."""
    q, k, v = _qkv(5, 1, 128, 2, 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ring = ishmem_device.ring_attention(tq, tk, tv, npes=npes)
    torch.testing.assert_close(ring, flash_attn.flash_attention(tq, tk, tv),
                               atol=5e-5, rtol=1e-5)
    want = ref_oracles.flash_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(ring.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-5)


def test_flash_partial_merge_equals_full(counts):
    """Partials of two KV halves at their absolute offsets (the second one
    blind for the first half's queries) merge to full attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 64, 2, 16))
    half = 32
    parts = [
        ishmem_device.flash_partial(q, k[:, :half], v[:, :half], q_off=0,
                                    k_off=0),
        ishmem_device.flash_partial(q, k[:, half:], v[:, half:], q_off=0,
                                    k_off=half),
    ]
    torch.testing.assert_close(ishmem_device.merge_partials(parts),
                               flash_attn.flash_attention(q, k, v),
                               atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("Sq,Skv,q_off,k_off", [
    (64, 64, 0, 0),           # diagonal shard
    (64, 32, 64, 32),         # a past shard: every key visible
    (64, 32, 0, 32),          # half the rows see no key
    (32, 32, 0, 32),          # a future shard: every row blind
])
def test_flash_partial_plain_matches_pallas(Sq, Skv, q_off, k_off, counts):
    """The partial itself within 2e-5 on rows that see at least one key,
    the reference's fully-masked values on the others (m = -1e30,
    l = Skv; acc = sum v to the same tolerance), and the merged output
    everywhere."""
    rng = np.random.default_rng(Sq * 7 + k_off)
    q = rng.normal(size=(1, Sq, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, Skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = ishmem_device.flash_partial(*map(torch.from_numpy, (q, k, v)),
                                      q_off=q_off, k_off=k_off)
    want = ref_ops.flash_partial(*map(jnp.asarray, (q, k, v)), q_off=q_off,
                                 k_off=k_off)
    seen = q_off + np.arange(Sq) >= k_off
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[:, seen], np.asarray(b)[:, seen],
                                   atol=2e-5, rtol=2e-5)
    blind = ~seen
    assert (got[1].numpy()[:, blind] == np.float32(-1e30)).all()
    np.testing.assert_array_equal(got[2].numpy()[:, blind],
                                  np.asarray(want[2])[:, blind])
    np.testing.assert_allclose(got[0].numpy()[:, blind],
                               np.asarray(want[0])[:, blind], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        ishmem_device.merge_partials([got]).numpy(),
        np.asarray(ref_ops.merge_partials([want])), atol=2e-5, rtol=2e-5)


def test_flash_partial_rejects_bad_input(counts):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        ishmem_device.flash_partial(q, torch.zeros(1, 8, 1, 16),
                                    torch.zeros(1, 8, 1, 16), q_off=0,
                                    k_off=0)
    with pytest.raises(TypeError):
        ishmem_device.flash_partial(q.double(), q.double(), q.double(),
                                    q_off=0, k_off=0)
    with pytest.raises(ValueError):
        ishmem_device.ring_attention(q, q, q, npes=3)


def test_flash_partial_on_meta_never_takes_the_plain_version(counts):
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        ishmem_device.flash_partial(q, q, q, q_off=0, k_off=0)
    rows = torch.zeros(2, 128, device="meta")
    with pytest.raises(ValueError):
        rt.reduce_tile(rows)


# ---------------------------------------------------------------------------
# 5. K9 against the Pallas reduce_tile (tests/test_kernels.py's grid)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("t,n,blk", [(2, 128, 128), (8, 1024, 256),
                                     (5, 640, 512)])
def test_reduce_tile_sweep_matches_pallas(op, t, n, blk, counts):
    rows = np.asarray(jax.random.uniform(jax.random.key(t * n), (t, n),
                                         minval=0.5, maxval=1.5))
    want = np.asarray(ref_ops.reduce_tile(jnp.asarray(rows), op, block=blk))
    got = ops.reduce_tile(torch.from_numpy(rows), op, block=blk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("op", ["sum", "max", "prod"])
def test_reduce_tile_dtypes_match_pallas(dtype, op, counts):
    """test_reduce_tile_dtypes' rows (sums below 2^24), every op, and bf16:
    bitwise, with int32 folded in f32 as the TPU kernel does."""
    rows = np.arange(4 * 256).reshape(4, 256) % 7 + (op == "prod")
    want = ref_ops.reduce_tile(jnp.asarray(rows).astype(dtype), op)
    got = ops.reduce_tile(torch.from_numpy(rows).to(getattr(torch, dtype)),
                          op)
    assert str(got.dtype).removeprefix("torch.") == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_reduce_tile_rejects_bad_input(counts):
    with pytest.raises(ValueError):
        ops.reduce_tile(torch.zeros(2, 100))
    with pytest.raises(ValueError):
        ops.reduce_tile(torch.zeros(2, 128), "mean")
    with pytest.raises(TypeError):
        ops.reduce_tile(torch.zeros(2, 128, dtype=torch.float64))


# ---------------------------------------------------------------------------
# 6. the ring-attention cost model, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("npes", [1, 2, 4, 8])
@pytest.mark.parametrize("kv_bytes", [256, 1 << 16, 1 << 24])
def test_ring_attention_models_match_reference(npes, kv_bytes):
    for compute in (0.0, 1e3, float(1 << 22)):
        for kw in ({}, {"work_items": 32}, {"tier": "dcn"}):
            for overlap in (False, True):
                assert cutover.t_ring_attention(
                    kv_bytes, compute, npes, overlap=overlap, **kw) == \
                    ref_cutover.t_ring_attention(
                        kv_bytes, compute, npes, overlap=overlap, **kw)
            assert cutover.ring_attention_overlap(
                kv_bytes, compute, npes, **kw) == \
                ref_cutover.ring_attention_overlap(
                    kv_bytes, compute, npes, **kw)


def test_launcher_fused_attn_on_cpu(capsys):
    sched = launch_serve.main(["--disagg", "--fused-attn", "--device", "cpu",
                               "--requests", "4", "--prompt-len", "12",
                               "--max-new", "5"])
    st_ = sched.stats
    assert sched.fused_attn
    assert (st_.prefills, st_.migrations, st_.admissions, st_.evictions) == \
        (4, 4, 4, 4)
    assert len(sched.ctx.pending) == 0
    for r in sched.requests.values():
        assert r.out == sched.engine.generate(
            r.batch, ServeConfig(max_new_tokens=5))[0].tolist()
    assert "(fused admission gate)" in capsys.readouterr().out


def test_launcher_seq_parallel_on_cpu(capsys):
    """``--seq-parallel 4``: 10 causal partials, merged within the ring
    tolerance of K2, and the reference's modeled step pricing (full
    qwen3-4b widths, 32768 tokens) to the float."""
    launch_serve.main(["--seq-parallel", "4", "--device", "cpu", "--batch",
                       "1", "--prompt-len", "16", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "device ops on the wire: device_put_nbi, device_put_nbi(pending)," \
        " device_signal_wait" in out
    rep = launch_serve.seq_parallel_report(4, prompt_len=16, device="cpu")
    assert rep["partials"] == 10 and rep["finite"]
    assert rep["shape"] == (1, 32, 4, 32) and rep["max_abs_err"] < 5e-5
    d = ref_base.get_config("qwen3-4b").d_model
    kv, comp = 2 * 8192 * d * 4, 4 * 8192 * d * 4
    assert (rep["t_blocking"], rep["t_overlap"], rep["overlap_ratio"]) == (
        ref_cutover.t_ring_attention(kv, comp, 4, overlap=False),
        ref_cutover.t_ring_attention(kv, comp, 4, overlap=True),
        ref_cutover.ring_attention_overlap(kv, comp, 4))


def test_seq_parallel_unit_scale_sees_a_border_mask_error(monkeypatch):
    """At unit-scale inputs the ring report still matches K2 within 5e-5,
    and a K10 that places every shard one key too late (an off-by-one at
    the shard borders) moves the merged output well past that limit."""
    rep = launch_serve.seq_parallel_report(4, prompt_len=64, scale=1.0,
                                           device="cpu")
    assert rep["partials"] == 10 and rep["finite"]
    assert rep["max_abs_err"] <= 5e-5
    right = ishmem_device.flash_partial

    def late(q, k, v, *, q_off, k_off):
        return right(q, k, v, q_off=q_off, k_off=k_off + 1)

    monkeypatch.setattr(ishmem_device, "flash_partial", late)
    bad = launch_serve.seq_parallel_report(4, prompt_len=64, scale=1.0,
                                           device="cpu")
    assert bad["max_abs_err"] > 5e-5
