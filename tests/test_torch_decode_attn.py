"""Decode attention over the gathered block payload (``kernels/
decode_attn.py``) and the paged step's payload form, on the CPU (the
kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds it
to this plain version there).

- The plain version is bitwise the decode step's own attention
  (``full_attn`` under the validity mask ``position <= pos``) over a dense
  cache and over a block-payload view of the same positions, at head dims
  64, 80 and 128, GQA ratios 1, 4 and 9, ragged rows and an overrun row;
  with a new column it stores it as the one-hot write does.
- The paged serving step in payload form is bitwise the leaf form, every
  token and every pool byte after every step, and greedy every request is
  its single-PE dense baseline; copy-on-write fires before any store into
  a shared block.
- Each view counts the forms its steps took and the leaf form's reasons,
  the scheduler's stats sum the views and each PE's last ``paged_decode``
  counter is its view's; the wrapper's charge, ``meta`` route and
  refusals.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import decode_attn
from repro_torch.launch import policy
from repro_torch.models import attention
from repro_torch.obs.tracer import SpanTracer, WallClock
from repro_torch.roofline import counter
from repro_torch.serve.paged_attn import PagedDecodeTally, PagedDecodeView

from _torch_decode_traffic import build
from _torch_threads import one_intra_op_thread  # noqa: F401

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
# reduced qwen3-4b in bf16 with 4 query heads a KV head
GQA4 = dict(BF16, num_heads=8, num_kv_heads=2)


def _cache(seed, B, nb, T, nkv, hd, g):
    """q, a dense (B, W, nkv, hd) K and V, and the same positions as views
    (B, nb, T, nkv, hd) into a payload whose blocks hold two repeats of K
    and V, as ``KVLayout.leaf_view`` cuts them."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen).bfloat16()

    q = draw(B, 1, nkv * g, hd)
    k, v = draw(B, nb * T, nkv, hd), draw(B, nb * T, nkv, hd)
    payload = draw(B, nb, 2, 2, T, nkv, hd).flatten(2)     # (B, nb, words)
    views = payload.unflatten(2, (2, 2, T, nkv, hd))[:, :, :, 1]
    views[:, :, 0].copy_(k.unflatten(1, (nb, T)))
    views[:, :, 1].copy_(v.unflatten(1, (nb, T)))
    return q, k, v, views[:, :, 0], views[:, :, 1]


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("g", [1, 4, 9])
@pytest.mark.parametrize("hd", [64, 80, 128])
def test_plain_is_the_decode_steps_attention(hd, g, store):
    """Ragged rows (the first position, one mid-block, the last) and a row
    past the cache: over the dense cache and over the payload view, the
    output is bitwise ``full_attn`` under ``position <= pos`` over the
    dense cache as the decode step writes it; a new column lands where the
    one-hot write puts it, and the overrun row stores nothing."""
    B, nb, T, nkv = 4, 5, 8, 2
    W = nb * T
    q, k, v, kp, vp = _cache(hd + g, B, nb, T, nkv, hd, g)
    pos = torch.tensor([0, 17, W - 1, W + 5])
    k_new = torch.randn(B, 1, nkv, hd).bfloat16() if store else None
    v_new = torch.randn(B, 1, nkv, hd).bfloat16() if store else None
    want_k, want_v = k.clone(), v.clone()
    if store:
        hot = torch.arange(W)[None, :] == pos[:, None]
        want_k = torch.where(hot[:, :, None, None], k_new, k)
        want_v = torch.where(hot[:, :, None, None], v_new, v)
    valid = torch.arange(W)[None, :] <= pos[:, None]
    want = attention.full_attn(q, want_k, want_v, mask=valid)
    got_dense = decode_attn.decode_attention(q, k, v, pos, k_new, v_new)
    got_view = decode_attn.decode_attention(q, kp, vp, pos, k_new, v_new)
    assert got_dense.dtype == torch.bfloat16
    assert torch.equal(got_dense, want) and torch.equal(got_view, want)
    for dense, view, w in ((k, kp, want_k), (v, vp, want_v)):
        assert torch.equal(dense, w)
        assert torch.equal(view.flatten(1, 2), w)


def test_the_wrapper_charges_its_formula_and_refuses_what_it_cannot_take():
    q, k, v, kp, vp = _cache(0, 2, 3, 8, 2, 64, 4)
    pos = torch.tensor([3, 20])
    with counter.count() as c:
        decode_attn.decode_attention(q, kp, vp, pos)
    by = c.summary()["by_kernel"]["decode_attention"]
    want = counter.decode_attn_work(2, 24, 8, 2, 64, 2)
    assert by["calls"] == 1 and by["flops"] == want["flops"] and \
        by["bytes"] == want["bytes"]
    meta = [t.to("meta") for t in (q, k, v, pos)]
    out = decode_attn.decode_attention(*meta)
    assert out.is_meta and out.shape == q.shape
    for bad in (dict(q=q[..., :60], k=k[..., :60], v=v[..., :60]),
                dict(q=torch.zeros(2, 1, 34, 64).bfloat16()),
                dict(k_new=torch.zeros(2, 1, 2, 64).bfloat16()),
                dict(pos=pos[:1])):
        with pytest.raises(ValueError):
            decode_attn.decode_attention(**dict(dict(q=q, k=k, v=v, pos=pos),
                                                **bad))


def _stepped(sched):
    """Step ``sched`` to its end; every pool after every step."""
    pools = []
    while not sched.done():
        sched.step()
        pools.append({dt: pool.clone()
                      for dt, pool in sched.heap.pools.items()})
    return pools


def _single_pe(sched):
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, dataclasses.replace(sched.scfg,
                                           max_new_tokens=req.max_new),
            num_slots=2, slot=req.slot), req.rid


@pytest.mark.parametrize("changes", [GQA4, dict(BF16, head_dim=80)],
                         ids=["gqa4-hd64", "mha-hd80"])
def test_payload_form_is_bitwise_the_leaf_form(changes, monkeypatch):
    """Reduced qwen3-4b with a bf16 cache over admissions, evictions and
    copy-on-write: in payload form (the engine's one payload buffer, no
    paged leaf in any bank) every pool byte after every step and every
    token equal the leaf form's, and greedy every request is its single-PE
    dense baseline."""
    sched = build("qwen3-4b", "cpu", **changes)
    pools = _stepped(sched)
    with monkeypatch.context() as m:
        m.setattr(PagedDecodeView, "form", lambda self: "layout")
        leaf = build("qwen3-4b", "cpu", **changes)
        want = _stepped(leaf)
    st = sched.stats
    assert st.cow_copies > 0 and st.admissions == st.evictions == 16
    steps = st.paged_decode.payload_steps
    assert steps >= st.decode_steps >= 20 and not st.paged_decode.leaf_steps
    assert leaf.stats.paged_decode.leaf_steps == {"layout": steps}
    assert [key[0] for key in sched.engine._buffers] == ["payload"]
    assert len(pools) == len(want)
    for got, exp in zip(pools, want):
        for dt, pool in got.items():
            assert torch.equal(pool, exp[dt]), dt
    for rid, req in sched.requests.items():
        assert req.out == leaf.requests[rid].out
    for bank in sched.banks.values():
        assert all(not entry for entry in bank.cache["blocks"])
    _single_pe(sched)


def test_copy_on_write_fires_before_the_store_into_a_shared_block(
        monkeypatch):
    """In payload form no writeback ever stores into a block another
    request maps: every shared block's bytes are the same after each
    writeback, and the boundary blocks were copied."""
    sched = build("qwen3-4b", "cpu", **GQA4)
    writeback = PagedDecodeView.writeback
    stores = []

    def checked(view, ctx, heap, *a):
        pool = view.pool
        shared = [b for b in range(pool.num_blocks) if pool.refcount(b) > 1]
        before = [heap.read(pool.block_ptr(b), view.pe).clone()
                  for b in shared]
        assert view.payload is not None
        heap = writeback(view, ctx, heap, *a)
        for b, was in zip(shared, before):
            assert torch.equal(heap.read(pool.block_ptr(b), view.pe), was)
        stores.append(len(shared))
        return heap

    monkeypatch.setattr(PagedDecodeView, "writeback", checked)
    sched.run()
    assert sched.stats.cow_copies > 0 and any(stores)


def test_the_paged_decode_counter_counts_forms_and_reasons():
    """Payload steps for a bf16 cache, with ``attn_repeat_kv`` set too
    (the cache keeps its unrepeated heads); leaf steps under ``layout``
    for an f32 cache and for latent attention's ``ckv``, under ``ring``
    for a windowed cache that wraps.  Each view counts its own steps, the
    stats are their sum, and each PE's last ``paged_decode`` counter on
    the tracer is its view's tally."""
    runs = {"payload": build("qwen3-4b", "cpu", requests=4, **GQA4),
            "f32": build("qwen3-4b", "cpu", requests=4),
            "mla": build("deepseek-v2-lite", "cpu", requests=4, **BF16),
            "ring": build("h2o-danube-3-4b", "cpu", requests=4, window=32,
                          **BF16)}
    tracer = runs["payload"].ctx.tracer = SpanTracer(clock=WallClock())
    for sched in runs.values():
        sched.run()
    with policy.use(policy.PerfPolicy(attn_repeat_kv=True)):
        runs["repeat_kv"] = build("qwen3-4b", "cpu", requests=4, **GQA4)
        runs["repeat_kv"].run()
    reason = {"payload": None, "f32": "layout", "mla": "layout",
              "ring": "ring", "repeat_kv": None}
    for name, sched in runs.items():
        tally, steps = sched.stats.paged_decode, sched.stats.decode_steps
        views = [sched.views[pe].forms for pe in sched.decode_pes]
        assert tally == PagedDecodeTally.total(views), name
        want = PagedDecodeTally()
        for _ in range(tally.payload_steps + sum(tally.leaf_steps.values())):
            want.count(reason[name])
        assert tally == want and tally.counter() == want.counter(), name
        assert want.counter()["payload_steps" if reason[name] is None else
                              "leaf_steps"] >= steps > 0
        assert all(view.payload_steps + sum(view.leaf_steps.values())
                   for view in views), name
    assert runs["ring"].pool.layout.ring
    last = {ev.tid: ev.args for ev in tracer.events
            if ev.ph == "C" and ev.name == "paged_decode"}
    sched = runs["payload"]
    assert last == {f"pe{pe}": sched.views[pe].forms.counter()
                    for pe in sched.decode_pes}
    assert all(c["leaf_steps"] == 0 for c in last.values())
