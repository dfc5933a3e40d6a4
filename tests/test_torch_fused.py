"""K11, fused paged attention, held against its composition and the JAX
package on the CPU.

K11 reads one layer of one paged K/V leaf through the slot table and
attends over it.  Its plain version (``fused_paged_attn_plain``) must be
bitwise equal to the composition the port ran before (K3's plain gather of
every block's whole payload, ``_extract_leaf`` and K2's plain version), and
``fused_paged_attn`` must agree with the reference's to the 5e-5 that
``tests/test_torch_device.py`` holds it to.  The pools are made from numpy
seeds: some slots unmapped, widths that are multiples of neither the block
nor 128, and a poisoned copy whose free blocks and rows past the width
hold NaN (neither version may read them); head dims 64, 80 (zamba2's)
and 128.  Zamba2's shared-attention leaves and whisper's decoder K/V (hd
64, cross K/V in the tail) are also held to the K11 law on a real
scheduler's pool (``tests/test_device.py``'s zamba2 and whisper cases).
``tests/test_torch_cuda.py`` holds the kernel bitwise against K3 + K2 on a
card.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import context as ref_context, device as ref_device
from repro.kernels import ishmem_device as ref_dev
from repro.models import model as ref_model
from repro.serve.engine import Engine as RefEngine, \
    ServeConfig as RefServeConfig
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.paged_attn import PagedDecodeView as RefView
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.core import context, device
from repro_torch.kernels import _build, flash_attn, ishmem_device, ops
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool, PagedLeaf
from repro_torch.serve.kvxfer import EXTRA_SIGNALS, KVMigrator
from repro_torch.serve.paged_attn import PagedDecodeView
from repro_torch.serve.scheduler import DisaggScheduler
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = 5e-5                 # tests/test_torch_device.py, fused_paged_attn
SLOTS = 3
FREE = 3                   # blocks no table maps

# (hd, q heads, kv heads, width, block tokens, layers): GQA 4 and 1, widths
# off the block and off 128, one width over two key tiles; head dim 80
# (zamba2's shared attention) in MHA and GQA 2
CASES = [(64, 8, 2, 37, 8, 3), (128, 4, 4, 45, 16, 2),
         (64, 4, 4, 130, 16, 2), (128, 8, 2, 20, 8, 2),
         (80, 4, 4, 37, 8, 3), (80, 8, 4, 130, 16, 2)]


@pytest.fixture
def counts():
    ops.reset_launches()
    yield ops.LAUNCHES
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}, \
        "a CPU tensor launched a kernel"


def _pool(case, seed, *, poison):
    """A two-unit layout, its pool row ``(R, block_words)`` as numpy f32,
    and the block ids of each slot: slot 0 maps every block, slot 1 its
    first half, slot 2 none.  With ``poison`` the free blocks and every
    row past the width of slot 0's last block hold NaN."""
    hd, nq, nkv, width, T, reps = case
    nb = -(-width // T)
    leaves = tuple(PagedLeaf(u, key, reps, width, nkv, hd)
                   for u in (0, 1) for key in ("k", "v"))
    lay = types.SimpleNamespace(
        block_tokens=T, blocks_per_request=nb, paged=leaves,
        block_words=sum(x.words_per_token for x in leaves) * T)
    rng = np.random.default_rng(seed)
    R = 2 * nb + FREE
    data = rng.normal(size=(R, lay.block_words)).astype(np.float32)
    ids = rng.permutation(R)
    tables = {0: sorted(ids[:nb].tolist()),
              1: sorted(ids[nb:nb + nb // 2 + 1].tolist())}
    if poison:
        data[ids[2 * nb:]] = np.nan                 # the free blocks
        last = tables[0][-1]
        tail = width - (nb - 1) * T                 # tokens used in it
        off = 0
        for leaf in leaves:
            seg = data[last, off:off + leaf.words_per_token * T].reshape(
                reps, T, nkv, hd)
            seg[:, tail:] = np.nan
            off += leaf.words_per_token * T
    q = rng.normal(size=(SLOTS, width, nq, hd)).astype(np.float32)
    return lay, data, tables, q


def _table(tables, R, nb):
    table = np.full((SLOTS, nb), R, np.int32)
    for s, ids in tables.items():
        table[s, :len(ids)] = ids
    return table


def _composition(data, table, q, lay, unit, layer):
    """K3's plain gather of every block's payload, the leaf slicing of
    ``assemble``, then K2's plain version: the port's route before K11."""
    pay = ishmem_device.paged_gather_plain(data, table)
    offs = ishmem_device._leaf_offsets(lay)
    kv = [ishmem_device._extract_leaf(pay, lay, leaf, SLOTS,
                                      offs[(unit, leaf.key)])[layer]
          for leaf in lay.paged if leaf.unit_idx == unit]
    return flash_attn.flash_attention_plain(q, *(x.contiguous()
                                                 for x in kv))


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_bitwise_equals_composition(case, dtype, poison, counts):
    lay, data, tables, q = _pool(case, 1, poison=poison)
    dt = getattr(torch, dtype)
    data_t, q_t = torch.from_numpy(data).to(dt), torch.from_numpy(q).to(dt)
    table = _table(tables, data.shape[0], lay.blocks_per_request)
    offs = ishmem_device._leaf_offsets(lay)
    leaf = lay.paged[2]                              # unit 1: k_off > 0
    for layer in (0, leaf.reps - 1):
        got = ishmem_device.fused_paged_attn_plain(
            data_t, table, q_t, k_off=offs[(1, "k")], v_off=offs[(1, "v")],
            leaf=leaf, layer=layer, block_tokens=lay.block_tokens)
        want = _composition(data_t, torch.from_numpy(table), q_t, lay, 1,
                            layer)
        assert got.dtype == dt and bool(got.isfinite().all())
        assert torch.equal(got, want)
        # the kernel's wrapper takes its plain version for CPU tensors
        routed = ishmem_device.paged_flash_attention(
            data_t, table, q_t, k_off=offs[(1, "k")], v_off=offs[(1, "v")],
            leaf=leaf, layer=layer, block_tokens=lay.block_tokens)
        assert torch.equal(routed, want)


@pytest.mark.parametrize("case", CASES)
def test_one_layer_is_the_composition_layer(case):
    """The layer that K11 reads is the layer ``_extract_leaf`` cuts from
    the whole payload, at every layer, unmapped slots giving zeros."""
    lay, data, tables, _ = _pool(case, 2, poison=True)
    table = torch.from_numpy(_table(tables, data.shape[0],
                                    lay.blocks_per_request))
    data_t = torch.from_numpy(data)
    pay = ishmem_device.paged_gather_plain(data_t, table)
    offs = ishmem_device._leaf_offsets(lay)
    for leaf in lay.paged:
        off = offs[(leaf.unit_idx, leaf.key)]
        whole = ishmem_device._extract_leaf(pay, lay, leaf, SLOTS, off)
        for layer in range(leaf.reps):
            got = ishmem_device.paged_layer_plain(
                data_t, table, off, leaf, layer, lay.block_tokens)
            assert torch.equal(got, whole[layer])
        assert not got[2].any()                      # slot 2: unmapped


def _heaps(data, pe=1):
    """The pool row ``data`` on PE ``pe`` of a reference heap and a port
    heap (CPU), each with one int32 signal word holding 2."""
    n = data.size
    rctx, rheap = ref_context.init(npes=2, node_size=2, heap_words=1 << 21)
    ctx, heap = context.init(npes=2, node_size=2, heap_words=1 << 21,
                             device="cpu")
    rptr, ptr = rheap.calloc((n,), "float32"), heap.calloc((n,), "float32")
    rsig, sig = rheap.calloc((), "int32"), heap.calloc((), "int32")
    rheap = rheap.write(rptr, pe, jnp.asarray(data.reshape(-1)))
    heap = heap.write(ptr, pe, torch.from_numpy(data.reshape(-1)))
    rheap = rheap.write(rsig, pe, jnp.asarray([2], jnp.int32))
    heap = heap.write(sig, pe, torch.tensor([2], dtype=torch.int32))
    return (rctx, rheap, rptr, rsig), (ctx, heap, ptr, sig)


def _views(lay, R, tables, rptr, ptr, pe=1):
    """A reference view and a port view over the same slot tables."""
    def pool(ptr):
        return types.SimpleNamespace(layout=lay, data=ptr, num_blocks=R,
                                     blocks_of=lambda rid: tables[rid])
    rview, view = RefView(pool(rptr), pe, SLOTS), \
        PagedDecodeView(pool(ptr), pe, SLOTS)
    for s in tables:
        rview.slots[s] = types.SimpleNamespace(req_id=s)
        view.slots[s] = types.SimpleNamespace(req_id=s)
    return rview, view


def _records(ctx):
    return [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
            for r in ctx.telemetry.trace]


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_fused_paged_attn_matches_reference(case, poison, counts):
    """``fused_paged_attn`` of both packages on the same heap bytes, views
    and signal waits: outputs within 5e-5 (and finite), the port's bitwise
    its composition, the telemetry records equal."""
    lay, data, tables, q = _pool(case, 3, poison=poison)
    R = data.shape[0]
    (rctx, rheap, rptr, rsig), (ctx, heap, ptr, sig) = _heaps(data)
    rview, view = _views(lay, R, tables, rptr, ptr)
    rwg = ref_device.work_group(rctx, size=128, pe=1)
    wg = device.work_group(ctx, size=128, pe=1)
    table = torch.from_numpy(view.table())
    assert np.array_equal(view.table(), _table(tables, R,
                                               lay.blocks_per_request))
    for unit in (0, 1):
        for layer in (0, lay.paged[0].reps - 1):
            heap, out = ishmem_device.fused_paged_attn(
                wg, heap, view, torch.from_numpy(q), unit_idx=unit,
                layer=layer, waits=[(sig, 2)])
            _, rout = ref_dev.fused_paged_attn(
                rwg, rheap, rview, jnp.asarray(q), unit_idx=unit,
                layer=layer, waits=[(rsig, 2)])
            assert bool(out.isfinite().all())
            assert torch.equal(out, _composition(
                torch.from_numpy(data), table, torch.from_numpy(q), lay,
                unit, layer))
            np.testing.assert_allclose(out.numpy(), np.asarray(rout),
                                       atol=TOL, rtol=TOL)
    assert _records(ctx) == _records(rctx)


def test_fused_never_gathers_whole_payloads(monkeypatch, counts):
    """On the CPU the fused path reads one layer of one leaf: neither K3
    nor its plain version (which copy every block's whole payload) is
    called."""
    def refuse(*a, **k):
        raise AssertionError("the whole payload was gathered")

    monkeypatch.setattr(ishmem_device, "paged_gather", refuse)
    monkeypatch.setattr(ishmem_device, "paged_gather_plain", refuse)
    lay, data, tables, q = _pool(CASES[0], 4, poison=True)
    _, (ctx, heap, ptr, sig) = _heaps(data)
    _, view = _views(lay, data.shape[0], tables, ptr, ptr)
    wg = device.work_group(ctx, size=128, pe=1)
    _, out = ishmem_device.fused_paged_attn(wg, heap, view,
                                            torch.from_numpy(q), layer=2)
    assert out.shape == q.shape and bool(out.isfinite().all())


def _fake(is_cuda, dtype):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype)


@pytest.mark.parametrize("pool,q,cast,route", [
    ("bfloat16", "bfloat16", None, "kernel"),
    ("bfloat16", "bfloat16", "bfloat16", "kernel"),
    ("bfloat16", "bfloat16", "float32", "composition"),
    ("float32", "float32", None, "composition"),
    ("float32", "bfloat16", "bfloat16", "composition"),
    ("bfloat16", "float32", None, "composition"),
])
def test_route_by_dtype(pool, q, cast, route):
    """On the card a bf16 pool and q launch K11; every other dtype keeps
    K3 + K2.  On the CPU every dtype takes the plain version."""
    dt = lambda name: None if name is None else getattr(torch, name)
    assert ishmem_device.fused_route(_fake(True, dt(pool)), _fake(
        True, dt(q)), dt(cast)) == route
    assert ishmem_device.fused_route(_fake(False, dt(pool)), _fake(
        False, dt(q)), dt(cast)) == "plain"


def test_bf16_on_the_cpu_takes_the_plain_version(counts):
    lay, data, tables, q = _pool(CASES[1], 5, poison=True)
    bf = torch.bfloat16
    _, (ctx, heap, ptr, sig) = _heaps(data)
    _, view = _views(lay, data.shape[0], tables, ptr, ptr)
    wg = device.work_group(ctx, size=128, pe=1)
    qt = torch.from_numpy(q).to(bf)
    _, out = ishmem_device.fused_paged_attn(wg, heap, view, qt, dtype=bf)
    want = _composition(torch.from_numpy(data).to(bf),
                        torch.from_numpy(view.table()), qt, lay, 0, 0)
    assert torch.equal(out, want)


def test_paged_flash_attention_refuses():
    lay, data, tables, q = _pool(CASES[0], 6, poison=False)
    R = data.shape[0]
    table = _table(tables, R, lay.blocks_per_request)
    data_t, q_t = torch.from_numpy(data), torch.from_numpy(q)
    leaf = lay.paged[0]
    kw = dict(k_off=0, v_off=leaf.words_per_token * lay.block_tokens,
              leaf=leaf, layer=0, block_tokens=lay.block_tokens)
    with pytest.raises(ValueError, match="leaf width"):
        ishmem_device.paged_flash_attention(data_t, table, q_t[:, :-1], **kw)
    with pytest.raises(IndexError, match="outside"):
        ishmem_device.paged_flash_attention(data_t, table + 1, q_t, **kw)
    with pytest.raises(TypeError, match="int32"):
        ishmem_device.paged_flash_attention(
            data_t, table.astype(np.int64), q_t, **kw)
    with pytest.raises(ValueError, match="overruns"):
        ishmem_device.paged_flash_attention(
            data_t, table, q_t, **{**kw, "v_off": lay.block_words - 1})


def test_build_table_carries_the_new_entries():
    """K11's entry point is bound, and K8's takes the epoch."""
    sig = _build.SIGNATURES
    assert len(sig["ishmem_fused_paged_attn"]) == 20
    assert sig["ishmem_barrier_push"][4] is _build._I
    assert "fused_paged_attn" in ops.LAUNCHES


def _fused_law(arch, batch_fn, unit):
    """Reduced ``arch`` served with the fused protocol on both packages to
    its first decode step; over the decode pool the scheduler leaves,
    device-gathered K/V of the paged leaves at ``unit`` feed K2 bitwise as
    ``assemble`` does and agree with the reference's ``fused_paged_attn``
    to 5e-5; the tokens then match.  Returns the port's layout."""
    rcfg = ref_base.reduced(ref_base.get_config(arch))
    cfg = base.reduced(base.get_config(arch))
    rp = ref_model.init_params(jax.random.key(0), rcfg)
    pp = _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    rpool = RefKVPool.create(rheap, rcfg, 24, num_blocks=32, max_slots=2,
                             block_tokens=4)
    pool = KVPool.create(heap, cfg, 24, num_blocks=32, max_slots=2,
                         block_tokens=4)
    rs = RefScheduler(rctx, rheap, RefEngine(rcfg, rp, max_len=24), rpool,
                      RefKVMigrator(rctx, rpool), prefill_pes=[0, 1],
                      decode_pes=[2], num_slots=2,
                      scfg=RefServeConfig(max_new_tokens=5), fused_attn=True)
    ps = DisaggScheduler(ctx, heap, Engine(cfg, pp, max_len=24,
                                           device="cpu"), pool,
                         KVMigrator(ctx, pool), prefill_pes=[0, 1],
                         decode_pes=[2], num_slots=2,
                         scfg=ServeConfig(max_new_tokens=5), fused_attn=True)
    batch = batch_fn(cfg, np.random.default_rng(3))
    rs.submit({k: jnp.asarray(v) for k, v in batch.items()})
    ps.submit({k: torch.from_numpy(v) for k, v in batch.items()})
    guard = 0
    while not ps.stats.admissions and guard < 50:
        rs.step()
        ps.step()
        guard += 1
    rs.step()
    ps.step()                             # one decode: all blocks consumed
    assert rs.stats.admissions == ps.stats.admissions == 1
    lay = ps.pool.layout
    assert [(x.unit_idx, x.key) for x in lay.paged] == [(unit, "k"),
                                                         (unit, "v")]
    view, rview = ps.views[2], rs.views[2]
    assembled = view.assemble(ps.heap, ps.banks[2].cache)
    wg = device.work_group(ctx, size=128, pe=2)
    rwg = ref_device.work_group(rctx, size=128, pe=2)
    leaf = lay.paged[0]
    qn = np.random.default_rng(11).normal(
        size=(view.num_slots, leaf.width, cfg.num_heads, leaf.hd)).astype(
            np.float32)
    for layer in (0, leaf.reps - 1):
        _, out = ishmem_device.fused_paged_attn(
            wg, ps.heap, view, torch.from_numpy(qn), layer=layer,
            waits=[(pool.sig_ptr(0), EXTRA_SIGNALS)])
        k = assembled["blocks"][unit]["k"][layer].contiguous()
        v = assembled["blocks"][unit]["v"][layer].contiguous()
        assert torch.equal(out, flash_attn.flash_attention(
            torch.from_numpy(qn), k, v))
        _, rout = ref_dev.fused_paged_attn(
            rwg, rs.heap, rview, jnp.asarray(qn), layer=layer,
            waits=[(rpool.sig_ptr(0), EXTRA_SIGNALS)])
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=TOL,
                                   rtol=TOL)
    assert _records(ctx) == _records(rctx)
    rs.run()
    ps.run()
    assert [r.out for r in ps.requests.values()] == \
        [[int(t) for t in r.out] for r in rs.requests.values()]
    return lay


def _tokens(cfg, rng, S=10):
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(1, S)).astype(np.int32)}


def test_zamba2_fused_paged_attn_bitwise_vs_assemble(counts):
    """tests/test_device.py's zamba2 case: the shared attention block's
    one paged K and V leaf among the Mamba2 tail."""
    lay = _fused_law("zamba2_2_7b", _tokens, unit=5)
    assert len(lay.tail) == 10


def test_whisper_fused_paged_attn_bitwise_vs_assemble(counts):
    """tests/test_device.py's whisper case: the decoder's self-attention
    K/V paged at head dim 64 (MHA), the encoder's cross K/V, projected
    from the request's audio embeddings, in the tail."""
    def batch(cfg, rng):
        b = _tokens(cfg, rng)
        b["audio_embeds"] = 0.1 * rng.normal(
            size=(1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return b
    lay = _fused_law("whisper_medium", batch, unit=0)
    assert [(t.key, t.shape[2]) for t in lay.tail] == [("ck", 32),
                                                      ("cv", 32)]
    assert lay.paged[0].hd == 64
