"""Chunked streaming, shared prefixes with copy-on-write and dense
rehydrate in the port: the laws of ``tests/test_paged.py`` and the
streaming and dense oracles of ``tests/test_disagg.py``, proved again on
the port at the reduced qwen3-4b size (f32, 4 PEs, a 24-token cache).

1. a streamed admission never reads ahead of its signal: blocks whose
   installment has not flushed read zero at the decode PE, the signal word
   counts exactly the flushed blocks, and admission stays shut until the
   stream closes;
2. shared-prefix mapping is refcount-correct: identical prefixes map the
   same blocks, copy-on-write keeps the shared rows pristine at every PE,
   and eviction under starvation and rotation never double-frees nor frees
   a block another request still maps;
3. every mode decodes bitwise equal to the single-PE baseline, and the
   dense-rehydrate control equals paged decode.

The kvpool half that has a reference counterpart with arrays
(``insert_blocks``) is also held against the JAX package here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihyp import given, settings, strategies as st

from repro_torch.configs import base
from repro_torch.core import context, heap as heap_mod
from repro_torch.core import pending as pending_mod
from repro_torch.models import model
from repro_torch.serve import kvpool as kvpool_mod
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import EXTRA_SIGNALS, KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler, Request
from _torch_threads import one_intra_op_thread  # noqa: F401

MAXLEN = 24


_CACHE = {}


def _params():
    """The reduced model's weights, built once (the property test takes no
    fixtures)."""
    if "p" not in _CACHE:
        cfg = base.reduced(base.get_config("qwen3-4b"))
        _CACHE["p"] = model.init_params(cfg, seed=0, device="cpu")
    return _CACHE["p"]


@pytest.fixture(scope="module")
def params():
    return _params()


def _setup(params, *, npes=4, num_blocks=32, max_slots=3, block_tokens=4):
    cfg = base.reduced(base.get_config("qwen3-4b"))
    ctx, heap = context.init(npes=npes, node_size=npes, device="cpu")
    eng = Engine(cfg, params, max_len=MAXLEN, device="cpu")
    pool = KVPool.create(heap, cfg, MAXLEN, num_blocks=num_blocks,
                         max_slots=max_slots, block_tokens=block_tokens)
    return cfg, ctx, heap, eng, pool


def _sched(ctx, heap, eng, pool, *, decode_pes=(2, 3), num_slots=2, NEW=5,
           temperature=0.0, **kw):
    return DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool), prefill_pes=[0, 1],
        decode_pes=list(decode_pes), num_slots=num_slots,
        scfg=ServeConfig(max_new_tokens=NEW, temperature=temperature), **kw)


def _prompt(S=10, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 512, size=(1, S))).long()


def _base(eng, p, NEW):
    return eng.generate({"tokens": p}, ServeConfig(max_new_tokens=NEW))[0]


def _run(sched, *, guard=300, each=None):
    steps = 0
    while not sched.done():
        sched.step()
        if each is not None:
            each()
        steps += 1
        assert steps < guard
    return {rid: r.out for rid, r in sched.requests.items()}


# ---------------------------------------------------------------------------
# 1. streamed admission against the pending-queue oracle
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 3), st.integers(8, 14))
def test_stream_chunks_gate_on_signal(chunk, S):
    """At every point of a chunked migration: unflushed blocks read zero at
    the decode PE, the signal equals the flushed wire blocks, and the full
    threshold stays shut until the stream closes."""
    cfg, ctx, heap, eng, pool = _setup(_params(), max_slots=1)
    mig = KVMigrator(ctx, pool)
    tok, _, cache1 = eng.prefill_request({"tokens": _prompt(S)})
    heap, ids = mig.stage(heap, 0, cache1, prompt_len=S, src_pe=0)
    stream = mig.open_stream(0, src_pe=0, dst_pe=1, slot=0, prompt_len=S,
                             first_token=tok)
    assert stream.pending == ids
    sig = pool.sig_ptr(0)
    flushed = 0
    while stream.pending:
        heap = mig.stream_chunk(heap, stream, chunk)
        for bid in ids[flushed:]:
            ptr = pool.block_ptr(bid)
            assert torch.equal(heap.read(ptr, 1), torch.zeros(ptr.size))
        assert int(heap.read(sig, 1)) == flushed
        heap = mig.stream_flush(heap, stream)
        flushed = stream.sent
        assert int(heap.read(sig, 1)) == flushed
        for bid in ids[:flushed]:
            assert torch.equal(heap.read(pool.block_ptr(bid), 1),
                               heap.read(pool.block_ptr(bid), 0))
        heap, hdr = mig.try_admit(heap, 0, 1, stream.expected)
        assert hdr is None
    heap, rep = mig.stream_close(heap, stream)
    assert rep.expected_signal == len(ids) + EXTRA_SIGNALS
    heap, hdr = mig.try_admit(heap, 0, 1, rep.expected_signal)
    assert hdr == {"req_id": 0, "prompt_len": S, "first_token": tok,
                   "n_blocks": len(ids)}
    assert len(ctx.pending) == 0


def test_stream_flush_completes_only_this_slots_prefix(params):
    """Draining one stream's installment leaves another slot's traffic,
    submitted after it, on the queue."""
    cfg, ctx, heap, eng, pool = _setup(params, max_slots=2)
    mig = KVMigrator(ctx, pool)
    streams = []
    for rid in range(2):
        tok, _, c1 = eng.prefill_request({"tokens": _prompt(8, seed=rid)})
        heap, ids = mig.stage(heap, rid, c1, prompt_len=8, src_pe=0)
        streams.append(mig.open_stream(rid, src_pe=0, dst_pe=1, slot=rid,
                                       prompt_len=8, first_token=tok))
    heap = mig.stream_chunk(heap, streams[0], 1)
    heap = mig.stream_chunk(heap, streams[1], 1)
    heap = mig.stream_flush(heap, streams[0])
    assert int(heap.read(pool.sig_ptr(0), 1)) == 1
    assert ctx.pending.pending_for(pool.sig_ptr(1), 1) is not None
    heap = mig.stream_flush(heap, streams[1])
    assert int(heap.read(pool.sig_ptr(1), 1)) == 1
    assert mig.pending_ops() == 0


def test_parked_stream_ramps_its_own_word(params):
    """A slot-less stream ramps a pool stream-signal word, never a slot's;
    the slot binds at close, and the word is recycled at admission."""
    cfg, ctx, heap, eng, pool = _setup(params)
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2], num_slots=1,
                   stream_chunks=1, admit_delay_steps=1)
    sched.submit({"tokens": _prompt(10)})
    sched.step()
    req = sched.requests[0]
    sid = req.park_sig
    assert req.state == "streaming" and req.slot == -1
    assert sid >= 0 and pool.stats()["streams_active"] == 1
    sched.step()                        # the first installment drained
    assert int(sched.heap.read(pool.stream_sig_ptr(sid), 2)) >= 1
    assert int(sched.heap.read(pool.sig_ptr(0), 2)) == 0
    outs = _run(sched)
    assert req.park_sig == -1 and pool.stats()["streams_active"] == 0
    assert int(sched.heap.read(pool.stream_sig_ptr(sid), 2)) == 0
    assert outs[0] == _base(eng, _prompt(10), 5).tolist()


# ---------------------------------------------------------------------------
# 2. shared prefix: mapping, copy-on-write, refcount-correct eviction
# ---------------------------------------------------------------------------


def test_shared_prefix_maps_same_blocks_bitwise(params):
    """Identical prompts declared as a whole-prompt prefix map the same
    blocks and decode bitwise equal to the single-PE baseline."""
    cfg, ctx, heap, eng, pool = _setup(params)
    NEW = 5
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2], num_slots=3,
                   NEW=NEW, shared_prefix=True)
    p = _prompt(10)                              # 10 % 4 != 0: boundary COW
    for _ in range(3):
        sched.submit({"tokens": p}, prefix_len=10)
    outs = _run(sched)
    st_ = sched.stats
    assert st_.prefix_hits == 2
    assert st_.blocks_prefix_shared == 2 * 3     # ceil(10/4) blocks each
    assert st_.bytes_wire_saved > 0
    assert st_.cow_copies == 3                   # every mapper COWs boundary
    base_out = _base(eng, p, NEW)
    for i in range(3):
        assert outs[i] == base_out.tolist()
    assert pool.stats()["blocks_in_use"] == 0


def test_shared_prefix_with_divergent_suffixes(params):
    """Prompts sharing only a declared prefix: whole blocks inside it are
    shared, the boundary stays private, each matches its own baseline."""
    cfg, ctx, heap, eng, pool = _setup(params)
    NEW = 4
    sched = _sched(ctx, heap, eng, pool, NEW=NEW, shared_prefix=True)
    P, S = 8, 12
    head = _prompt(P, seed=5)
    prompts = [torch.cat([head, _prompt(S - P, seed=20 + i)], dim=1)
               for i in range(3)]
    for p in prompts:
        sched.submit({"tokens": p}, prefix_len=P)
    outs = _run(sched)
    assert sched.stats.prefix_hits == 2
    assert sched.stats.blocks_prefix_shared == 2 * (P // 4)
    assert sched.stats.cow_copies == 0
    for i, p in enumerate(prompts):
        assert outs[i] == _base(eng, p, NEW).tolist()
    assert pool.stats()["blocks_in_use"] == 0


def test_whole_prefix_after_partial_mapper_resends_boundary(params):
    """Residency is per (decode PE, block): a whole-prompt mapper landing
    where only a shorter mapper's whole blocks are resident must still
    send the boundary block."""
    cfg, ctx, heap, eng, pool = _setup(params)
    NEW = 4
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2, 3], num_slots=2,
                   NEW=NEW, shared_prefix=True)
    P = 10
    p = _prompt(P)
    longer = torch.cat([p, _prompt(4, seed=33)], dim=1)
    # A->(2,0) registers, B->(3,0) maps 2 blocks, C->(2,1) skips 3,
    # D->(3,1) is whole-prompt where only B's 2 are resident
    for batch in (p, longer, p, p):
        sched.submit({"tokens": batch}, prefix_len=P)
    outs = _run(sched)
    assert sched.stats.bytes_wire_saved == 5 * pool.layout.block_bytes
    base_p, base_l = _base(eng, p, NEW), _base(eng, longer, NEW)
    for rid, want in [(0, base_p), (1, base_l), (2, base_p), (3, base_p)]:
        assert outs[rid] == want.tolist()
    assert pool.stats()["blocks_in_use"] == 0


def test_cow_keeps_shared_payload_pristine_under_divergence(params):
    """Sampled decoding makes the mapped requests diverge; the prefix
    entry's blocks at the decode PE stay equal to the staged rows after
    every step, which only copy-on-write makes true."""
    cfg, ctx, heap, eng, pool = _setup(params)
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2], num_slots=2, NEW=6,
                   temperature=0.7, shared_prefix=True)
    p = _prompt(10)
    for _ in range(2):
        sched.submit({"tokens": p}, prefix_len=10)
    seen = {}

    def pristine():
        if not seen and sched.prefix_index:
            entry = next(iter(sched.prefix_index.values()))
            seen["ids"], seen["home"] = list(entry.block_ids), entry.home_pe
        for bid in seen.get("ids", []):
            if pool.refcount(bid) == 0:
                continue
            assert torch.equal(sched.heap.read(pool.block_ptr(bid), 2),
                               sched.heap.read(pool.block_ptr(bid),
                                               seen["home"]))
    _run(sched, each=pristine)
    assert seen and sched.stats.cow_copies >= 1
    assert pool.stats()["blocks_in_use"] == 0


def _refcount_invariant(sched, pool):
    """Every block's refcount is the tables mapping it, plus the live COW
    reserves holding it, plus the prefix entries owning it; a block at
    zero is on the free list."""
    expect = [0] * pool.num_blocks
    for ids in pool.block_tables.values():
        for i in ids:
            expect[i] += 1
    for view in sched.views.values():
        for sm in view.slots.values():
            for bid in sm.cow.values():
                expect[bid] += 1
    for req in sched.requests.values():
        for bid in req.cow_plan.values():
            expect[bid] += 1
    for entry in sched.prefix_index.values():
        for bid in entry.block_ids:
            expect[bid] += 1
    for i in range(pool.num_blocks):
        assert pool.refcount(i) == expect[i], i
        if pool.refcount(i) == 0:
            assert i in pool._free


def test_refcount_eviction_under_starvation_and_rotation(params):
    """A pool too small for every shared-prefix request at once, streamed
    and rotated: the refcount invariant holds after every step, and the
    pool drains to empty with every stream right."""
    cfg, ctx, heap, eng, pool = _setup(params, num_blocks=10, max_slots=2)
    NEW = 4
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2, 3], num_slots=2,
                   NEW=NEW, shared_prefix=True, stream_chunks=1)
    p, other = _prompt(10), _prompt(9, seed=9)
    for i in range(6):
        if i % 2 == 0:
            sched.submit({"tokens": p}, prefix_len=10)
        else:
            sched.submit({"tokens": other})
    outs = _run(sched, each=lambda: _refcount_invariant(sched, pool))
    assert sched.stats.stalled_on_pool > 0 or sched.stats.stalled_on_slots > 0
    assert pool.stats()["blocks_in_use"] == 0
    base_p, base_o = _base(eng, p, NEW), _base(eng, other, NEW)
    for i in range(6):
        assert outs[i] == (base_p if i % 2 == 0 else base_o).tolist()


def test_pool_sharing_api_refcounts(params):
    """alloc_with_prefix increfs, reserve holds blocks outside tables,
    remap moves the reserve in and drops the shared reference, release
    frees only at zero; stream words are allocated and freed once."""
    cfg, ctx, heap, eng, pool = _setup(params, num_blocks=8)
    a = pool.alloc(1, 3)
    assert pool.free_blocks() == 5
    b = pool.alloc_with_prefix(2, a[:2], 4)
    assert b[:2] == a[:2] and len(b) == 4
    assert pool.refcount(a[0]) == 2 and pool.refcount(a[2]) == 1
    assert pool.stats()["blocks_shared"] == 2
    res = pool.reserve(1)
    assert pool.free_blocks() == 8 - 3 - 2 - 1
    old = pool.remap(2, 1, res[0])
    assert old == a[1] and pool.refcount(a[1]) == 1
    assert pool.blocks_of(2)[1] == res[0] and pool.refcount(res[0]) == 1
    assert pool.release(1) == 2
    assert pool.refcount(a[0]) == 1
    assert pool.release(2) == 4
    assert pool.free_blocks() == 8
    with pytest.raises(ValueError):
        pool.incref([a[0]])
    assert pool.release_ids([]) == 0
    assert pool.alloc_with_prefix(3, [], 9) is None and 3 not in \
        pool.block_tables
    sid = pool.alloc_stream_sig()
    assert pool.stats()["streams_active"] == 1
    pool.free_stream_sig(sid)
    with pytest.raises(ValueError):
        pool.free_stream_sig(sid)
    with pytest.raises(IndexError):
        pool.stream_sig_ptr(pool.max_streams)


def test_prefix_plan_refuses_multimodal_batches(params):
    """A batch with non-token inputs never maps nor registers a prefix."""
    cfg, ctx, heap, eng, pool = _setup(params)
    sched = _sched(ctx, heap, eng, pool, shared_prefix=True)
    tok = _prompt(8)
    mm = Request(rid=0, batch={"tokens": tok,
                               "audio_embeds": torch.zeros(1, 4, 8)},
                 max_new=4, prefix_len=8)
    assert sched._prefix_plan(mm) == ([], None, 0)
    plain = Request(rid=1, batch={"tokens": tok}, max_new=4, prefix_len=8)
    ids, key, n = sched._prefix_plan(plain)
    assert key is not None and n == 2            # 8 tokens = 2 whole blocks


def test_ring_layouts_never_share_a_prefix():
    """A ring layout (reduced h2o-danube at a cache above its window of
    64) neither maps nor registers a prefix: its occupied slots wrap
    through every block.  So a whole-prompt prefix on a ring demands no
    copy-on-write reserve, and a request needing every pool block stays
    schedulable (``tests/test_paged.py``'s multimodal rule, for rings)."""
    cfg = base.reduced(base.get_config("h2o-danube-3-4b"))
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    eng = Engine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                 max_len=80, device="cpu")
    pool = KVPool.create(heap, cfg, 80, num_blocks=16, max_slots=3,
                         block_tokens=4)
    assert pool.layout.ring and pool.layout.blocks_for_decode(70, 4) == 16
    sched = _sched(ctx, heap, eng, pool, NEW=4, shared_prefix=True)
    p = _prompt(70)
    req = Request(rid=0, batch={"tokens": p}, max_new=4, prefix_len=70)
    assert sched._prefix_plan(req) == ([], None, 0)
    assert not sched._needs_boundary_cow({"tokens": p}, 70, 70)
    sched.submit({"tokens": p}, prefix_len=70)
    sched.submit({"tokens": p}, prefix_len=70)
    outs = _run(sched)
    assert sched.stats.prefix_hits == 0 and not sched.prefix_index
    assert list(outs.values()) == [_base(eng, p, 4).tolist()] * 2


def test_submit_rejects_unschedulable_cow_request(params):
    """A whole-prompt unaligned prefix needs its table plus one COW
    reserve; a pool of exactly table-many blocks refuses it at submit."""
    NEW = 4
    cfg, ctx, heap, eng, pool = _setup(params, num_blocks=4)
    assert pool.layout.blocks_for_decode(10, NEW) == 4
    sched = _sched(ctx, heap, eng, pool, NEW=NEW, shared_prefix=True)
    p = _prompt(10)
    with pytest.raises(ValueError):
        sched.submit({"tokens": p}, prefix_len=10)
    sched2 = _sched(ctx, heap, eng, pool, NEW=NEW, shared_prefix=True)
    sched2.submit({"tokens": p, "audio_embeds": torch.zeros(1, 2, 4)},
                  prefix_len=10)
    sched.submit({"tokens": p})                  # no prefix: fits exactly
    assert _run(sched)[0] == _base(eng, p, NEW).tolist()


# ---------------------------------------------------------------------------
# 3. bitwise laws of the modes
# ---------------------------------------------------------------------------


def test_assembled_leaves_equal_dense_rehydrate(params):
    """After admission the paged view's assembled cache equals what
    insert_blocks rehydrates from the gathered payloads, byte for byte."""
    cfg, ctx, heap, eng, pool = _setup(params)
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2], num_slots=2)
    sched.submit({"tokens": _prompt(10)})
    for _ in range(50):
        if sched.stats.admissions:
            break
        sched.step()
    view, bank = sched.views[2], sched.banks[2]
    assembled = view.assemble(sched.heap, bank.cache)
    rid = next(iter(pool.block_tables))
    payloads, tail = sched.migrator.gather(sched.heap, rid, 0, 2)
    dense = kvpool_mod.insert_blocks(pool.layout, eng.init_slots(2).cache,
                                     0, payloads)
    for pl in pool.layout.paged:
        assert torch.equal(assembled["blocks"][pl.unit_idx][pl.key][:, 0],
                           dense["blocks"][pl.unit_idx][pl.key][:, 0])
    _run(sched)


def test_insert_blocks_matches_reference():
    """The dense rehydrate's scatter against the JAX package's, on the
    same payloads (a ragged last block included)."""
    from repro.configs import base as ref_base
    from repro.models import kvcache as ref_kvcache
    from repro.serve import kvpool as ref_kvpool
    from repro_torch.models import kvcache
    cfg = base.reduced(base.get_config("qwen3-4b"))
    rcfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    lay = kvpool_mod.build_layout(cfg, 22, block_tokens=4)
    rlay = ref_kvpool.build_layout(rcfg, 22, block_tokens=4)
    rng = np.random.default_rng(3)
    pays = [rng.normal(size=lay.block_words).astype(np.float32)
            for _ in range(lay.blocks_per_request)]
    got = kvpool_mod.insert_blocks(lay, kvcache.init_cache(cfg, 3, 22, "cpu"),
                                   1, [torch.from_numpy(x) for x in pays])
    want = ref_kvpool.insert_blocks(rlay, ref_kvcache.init_cache(rcfg, 3, 22),
                                    1, [jnp.asarray(x) for x in pays])
    assert lay.block_words == rlay.block_words and lay.paged
    for pl in lay.paged:
        np.testing.assert_array_equal(
            got["blocks"][pl.unit_idx][pl.key].numpy(),
            np.asarray(want["blocks"][pl.unit_idx][pl.key]))


def _disagg(params, *, n_req=5, num_slots=3, NEW=6, admit_delay=0,
            **kw):
    cfg, ctx, heap, eng, pool = _setup(params, block_tokens=8)
    sched = _sched(ctx, heap, eng, pool, num_slots=num_slots, NEW=NEW,
                   admit_delay_steps=admit_delay, **kw)
    prompts = [_prompt(10, seed=40 + i) for i in range(n_req)]
    for p in prompts:
        sched.submit({"tokens": p})
    return sched, prompts, _run(sched), eng


@pytest.mark.parametrize("shared", [False, True])
def test_serving_stores_into_the_live_pools(params, shared, monkeypatch):
    """Every store of a disaggregated run (staging, the wire, signals,
    admission's zeroing, decode's writeback, copy-on-write) lands in the
    pool tensors set-up made: from the first step to the last the heap is
    one object, no pool moves, and nothing is copied but the deferred
    puts' staged payloads and their merged runs, while the stores are
    counted."""
    cfg, ctx, heap, eng, pool = _setup(params, block_tokens=4)
    payloads = []
    staged, merge = heap_mod.SymmetricHeap.staged, pending_mod._merge_puts

    def staged_counted(self, ptr, value):
        value = staged(self, ptr, value)
        payloads.append(value.numel() * value.element_size())
        return value

    def merge_counted(group):
        ptr, value = merge(group)
        if len(group) > 1:
            payloads.append(value.numel() * value.element_size())
        return ptr, value

    monkeypatch.setattr(heap_mod.SymmetricHeap, "staged", staged_counted)
    monkeypatch.setattr(pending_mod, "_merge_puts", merge_counted)
    sched = _sched(ctx, heap, eng, pool, decode_pes=[2, 3], num_slots=2,
                   NEW=6, temperature=0.7 if shared else 0.0,
                   shared_prefix=shared)
    for i in range(4):
        sched.submit({"tokens": _prompt(10, seed=1 if shared else 40 + i)},
                     **({"prefix_len": 10} if shared else {}))
    ptrs = {dt: t.data_ptr() for dt, t in heap.pools.items()}
    copied, stored = heap.tally.copy_bytes, heap.tally.store_bytes

    def in_place():
        assert sched.heap is heap
        assert {dt: t.data_ptr() for dt, t in heap.pools.items()} == ptrs
        assert heap.tally.copy_bytes == copied + sum(payloads)
    _run(sched, each=in_place)
    assert heap.tally.store_bytes > stored and sum(payloads) > 0
    assert sched.stats.cow_copies >= (1 if shared else 0)


def test_dense_rehydrate_fallback_matches_paged(params):
    """paged=False admits through gather + insert_blocks and decodes the
    slot bank's dense cache; both paths give identical streams, and the
    dense one never calls the paged gather."""
    _, _, paged, _ = _disagg(params)
    sched, _, dense, _ = _disagg(params, paged=False)
    assert paged == dense
    assert not sched.views
    lay = sched.pool.layout
    bank = sched.banks[2]
    leaf = bank.cache["blocks"][lay.paged[0].unit_idx][lay.paged[0].key]
    assert float(leaf.abs().max()) > 0           # the dense copy exists


@pytest.mark.parametrize("chunk", [1, 2])
def test_streaming_matches_baseline_bitwise(params, chunk):
    """Chunked streaming, with rotation, decodes bitwise equal to the
    single-PE baseline; each request goes out in several installments."""
    sched, prompts, outs, eng = _disagg(params, stream_chunks=chunk,
                                        admit_delay=1, n_req=4, NEW=5)
    assert sched.stats.stream_chunks >= len(prompts) * max(1, 2 // chunk)
    for i, p in enumerate(prompts):
        assert outs[i] == _base(eng, p, 5).tolist()


def test_streaming_shrinks_ttfd_window(params):
    """Installments drain under later prefill compute, so the modeled comm
    window from migration issue to admission shrinks."""
    whole = _disagg(params, admit_delay=1, n_req=4)[0].stats
    stream = _disagg(params, admit_delay=1, n_req=4, stream_chunks=1)[0].stats
    assert sum(stream.ttfd_model_s) / len(stream.ttfd_model_s) < \
        sum(whole.ttfd_model_s) / len(whole.ttfd_model_s)
