"""The port's CUDA kernels against their plain versions, on a card.

Imports no JAX and nothing of the JAX package, so it runs on a machine
that has the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out; the
``cuda`` marker is then unregistered, which only warns).  Without a card
every test here skips.  Data movement (K1, K3-K9) is compared bitwise,
attention (K2, K10) to the reference's tolerances, 2e-5 in f32 and 2e-2 in
bf16; K2's bf16 kernel is also held bitwise to itself run to run and across
batch positions, and K11 bitwise to K3 followed by K2.  Decode attention
(``kernels/decode_attn.py``) is held to its plain version in bf16 and
bitwise to itself run to run, across bank positions and sizes and between
a dense cache and a block-payload view.  The paged decode step replayed
as CUDA graphs is held bitwise to the eager step, and in payload form to
the leaf form.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.comms import api
from repro_torch.kernels import flash_attn, ishmem_device, ops, \
    reduce_tile as rt, ring_collectives as rc, rma_copy
from repro_torch.launch import serve
from repro_torch.obs.export import validate
from repro_torch.serve.kvpool import KVLayout, PagedLeaf

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card")]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py
NPES = 8


@pytest.fixture
def card():
    return torch.device("cuda")


def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# K1-K3 (moved from tests/test_torch_kernels.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_cuda_copy_into_bitwise(card, dtype):
    for n, off in ((1, 3), (127, 129), (100_000, 1000)):
        row = (torch.randn(200_000, device=card) * 50).to(getattr(torch, dtype))
        src = (torch.randn(n, device=card) * 50).to(row.dtype)
        want = rma_copy.copy_into_plain(row.clone(), src, off)
        assert torch.equal(rma_copy.copy_into(row, src, off), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 37, 512])
def test_cuda_flash_attention(card, dtype, S):
    q, k, v = (torch.from_numpy(x).to(card, getattr(torch, dtype))
               for x in _qkv(S, 1, S, 32, 8, 128))
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv", [(1, 32, 32), (37, 32, 8), (512, 32, 32),
                                     (129, 8, 1), (1000, 8, 2)])
def test_cuda_flash_hd80(card, dtype, S, H, Hkv):
    """Head dim 80 (zamba2's shared attention) in both dtypes, at odd S and
    under GQA, against the plain version; one K2 launch a call."""
    q, k, v = (torch.from_numpy(x).to(card, getattr(torch, dtype))
               for x in _qkv(S + H + Hkv, 1, S, H, Hkv, 80))
    ops.reset_launches()
    got = flash_attn.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = flash_attn.flash_attention_plain(q, k, v)
    assert got.shape == q.shape and bool(got.isfinite().all())
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _bf16_qkv(card, seed, B, S, H, Hkv, hd):
    return (torch.from_numpy(x).to(card, torch.bfloat16)
            for x in _qkv(seed, B, S, H, Hkv, hd))


@pytest.mark.parametrize("S", [1, 37, 63, 64, 65, 129, 512, 528, 1000])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (8, 8), (8, 1)])
def test_cuda_flash_bf16_grid(card, S, hd, H, Hkv):
    """The wgmma kernel over ragged tiles, the three head dims (80 pads its
    tiles to 128 columns) and head ratios 1:1, 4:1 and 8:1, within bf16's
    2e-2 of the plain version."""
    q, k, v = _bf16_qkv(card, S * 7 + H + Hkv + hd, 1, S, H, Hkv, hd)
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("B,S,H,Hkv,hd", [(3, 528, 32, 8, 128),
                                          (1, 4096, 32, 8, 128),
                                          (2, 1000, 8, 1, 64)])
def test_cuda_flash_bf16_batched_and_long(card, B, S, H, Hkv, hd):
    """K11's shape (3 slots of 528 keys), the long prefill and a ragged
    batched 8:1 case."""
    q, k, v = _bf16_qkv(card, S + B, B, S, H, Hkv, hd)
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("S,H,Hkv,hd", [(512, 32, 8, 128), (37, 8, 1, 64),
                                        (1000, 8, 8, 128), (528, 32, 8, 64),
                                        (512, 32, 32, 80), (77, 8, 2, 80)])
def test_cuda_flash_bf16_bitwise_laws(card, S, H, Hkv, hd):
    """Run to run and batch position give the same bits (the serving
    path's bitwise laws rest on both); a NaN neighbour batch stays out of
    batch 0, since rows past S are the tensor map's zero fill."""
    q, k, v = _bf16_qkv(card, S + hd, 2, S, H, Hkv, hd)
    k[1], v[1] = float("nan"), float("nan")
    pair = flash_attn.flash_attention(q, k, v)
    again = flash_attn.flash_attention(q, k, v)
    alone = flash_attn.flash_attention(q[:1].contiguous(), k[:1].contiguous(),
                                       v[:1].contiguous())
    assert bool(pair[0].isfinite().all())
    assert torch.equal(pair[:1], alone)
    assert torch.equal(pair[:1], again[:1])
    assert torch.equal(pair[1].isnan(), again[1].isnan())


@pytest.mark.parametrize("S,H,Hkv,hd", [(512, 40, 8, 128), (512, 56, 8, 128),
                                        (512, 36, 4, 128), (432, 16, 16, 64)])
def test_cuda_flash_bf16_serving_ratios(card, S, H, Hkv, hd):
    """The prefill shapes the remaining configurations give K2: head
    ratios 5, 7 and 9 (llama4-scout, arctic, starcoder2) at hd 128 and
    whisper's MHA at hd 64 over 432 tokens, within bf16's 2e-2 of the
    plain version and bitwise run to run."""
    q, k, v = _bf16_qkv(card, S + H + Hkv, 1, S, H, Hkv, hd)
    got = flash_attn.flash_attention(q, k, v)
    want = flash_attn.flash_attention_plain(q, k, v)
    assert bool(got.isfinite().all())
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert torch.equal(got, flash_attn.flash_attention(q, k, v))


def test_cuda_flash_bf16_rejects_unaligned_base(card):
    """TMA reads from 16-byte aligned bases only; an offset view raises."""
    q, k, v = _bf16_qkv(card, 0, 1, 64, 8, 8, 64)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=card)
    shifted = flat[1:].view(q.shape)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(shifted, k, v)


def test_cuda_paged_gather_bitwise(card):
    data = torch.randn(64, 4096, device=card).bfloat16()
    table = torch.randint(0, 65, (3, 9), device=card, dtype=torch.int32)
    assert torch.equal(ishmem_device.paged_gather(data, table),
                       ishmem_device.paged_gather_plain(data, table))


def _gather_case(card, case):
    """(data, numpy table) of one K3 edge shape."""
    rng = np.random.default_rng(len(case))
    g = torch.Generator(device=card).manual_seed(len(case))
    if case == "odd width":                     # 4-byte units
        return (torch.randn(10, 37, generator=g, device=card),
                rng.integers(0, 11, size=(3, 4)).astype(np.int32))
    if case == "base off the grid":             # 4-byte units
        flat = torch.randn(64 * 4096 + 1, generator=g, device=card)
        return (flat[1:].view(64, 4096),
                rng.integers(0, 65, size=(3, 9)).astype(np.int32))
    if case == "rows of several chunks":       # 32 KB a CTA, a short last one
        return (torch.randn(20, 3 * 16384 + 8, generator=g,
                            device=card).bfloat16(),
                rng.integers(0, 21, size=(4, 5)).astype(np.int32))
    data = torch.randn(64, 4096, generator=g, device=card).bfloat16()
    if case == "all unmapped":
        return data, np.full((3, 9), 64, np.int32)
    if case == "one entry":
        return data, np.array([[17]], np.int32)
    assert case == "more CTAs than SMs"
    return data, rng.integers(0, 65, size=(40, 33)).astype(np.int32)


@pytest.mark.parametrize("case", ["all unmapped", "one entry", "odd width",
                                  "base off the grid", "rows of several chunks",
                                  "more CTAs than SMs"])
def test_cuda_paged_gather_host_and_card_tables(card, case):
    """Bitwise with a host table (numpy and a CPU tensor) and with the same
    table on the card; the host tables make no device-to-host sync, which
    PyTorch's sync debug mode would turn into an error, as it does for the
    card table's one range read."""
    data, table = _gather_case(card, case)
    want = ishmem_device.paged_gather_plain(data,
                                            torch.from_numpy(table).to(card))
    ishmem_device.paged_gather(data, table)      # first pinned allocation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        from_numpy = ishmem_device.paged_gather(data, table)
        from_cpu = ishmem_device.paged_gather(data, torch.from_numpy(table))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    card_table = torch.from_numpy(table).to(card)
    torch.cuda.set_sync_debug_mode("error")
    try:        # the card table's range read is a sync, and the mode sees it
        with pytest.raises(RuntimeError):
            ishmem_device.paged_gather(data, card_table)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    from_card = ishmem_device.paged_gather(data, card_table)
    for got in (from_numpy, from_cpu, from_card):
        assert torch.equal(got, want)


def test_cuda_paged_gather_refuses_before_launch(card):
    data = torch.randn(8, 256, device=card)
    before = ops.LAUNCHES["paged_gather"]
    for bad in (np.array([[0, 9]], np.int32), np.array([[-1, 0]], np.int32)):
        with pytest.raises(IndexError):
            ishmem_device.paged_gather(data, bad)
        with pytest.raises(IndexError):
            ishmem_device.paged_gather(data, torch.from_numpy(bad).to(card))
    assert ops.LAUNCHES["paged_gather"] == before


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

# (hd, q heads, kv heads, width, block tokens, layers): chip_smoke.py's
# heads and width, GQA 4, 1 and 8, widths off the block and off 128, blocks
# of 8, 16 and 32 tokens; zamba2's 32 heads of 80 (MHA) and an hd-80 GQA;
# whisper's 16 heads of 64 (MHA) over its 448-token context
K11_CASES = [(128, 32, 8, 528, 16, 3), (64, 8, 2, 37, 8, 3),
             (128, 8, 8, 45, 16, 2), (64, 4, 4, 300, 32, 2),
             (128, 8, 1, 130, 16, 2), (80, 32, 32, 528, 16, 3),
             (80, 8, 2, 77, 8, 2), (64, 16, 16, 448, 16, 3)]


def _k11_pool(card, case, seed):
    """A two-unit layout, its bf16 pool row on the card, a (3, nb) host
    table (slot 0 maps every block, slot 1 its first half, slot 2 none) and
    q.  The free blocks and the rows past the width in slot 0's last block
    hold NaN: the kernel must read neither."""
    hd, nq, nkv, width, T, reps = case
    nb = -(-width // T)
    leaves = tuple(PagedLeaf(u, key, reps, width, nkv, hd)
                   for u in (0, 1) for key in ("k", "v"))
    lay = KVLayout(
        block_tokens=T, blocks_per_request=nb,
        block_words=sum(x.words_per_token for x in leaves) * T,
        tail_words=1, kv_dtype="bfloat16", cache_width=width, ring=False,
        paged=leaves, tail=())
    rng = np.random.default_rng(seed)
    R = 2 * nb + 3
    data = torch.from_numpy(rng.normal(size=(R, lay.block_words)).astype(
        np.float32)).to(card, torch.bfloat16)
    ids, half = rng.permutation(R), nb // 2 + 1
    table = np.full((3, nb), R, np.int32)
    table[0] = np.sort(ids[:nb])
    table[1, :half] = np.sort(ids[nb:nb + half])
    data[torch.from_numpy(ids[nb + half:]).to(card)] = float("nan")
    off, tail = 0, width - (nb - 1) * T
    for leaf in leaves:
        n = leaf.words_per_token * T
        data[int(table[0, -1]), off:off + n].view(
            reps, T, nkv, hd)[:, tail:] = float("nan")
        off += n
    q = torch.from_numpy(rng.normal(size=(3, width, nq, hd)).astype(
        np.float32)).to(card, torch.bfloat16)
    return lay, data, table, q


def _k11_composition(data, table, q, lay, unit, layer):
    """K3 over every table block, the leaf slicing of ``assemble``, K2."""
    pay = ishmem_device.paged_gather(data, table)
    k, v = (lay.gathered_leaf(pay, x)[layer]
            for x in lay.paged if x.unit_idx == unit)
    return flash_attn.flash_attention(q, k.contiguous(), v.contiguous())


def _k11_kwargs(lay, unit, layer):
    offs = lay.leaf_offsets
    return dict(k_off=offs[(unit, "k")], v_off=offs[(unit, "v")],
                leaf=lay.paged[2 * unit], layer=layer,
                block_tokens=lay.block_tokens)


@pytest.mark.parametrize("case", K11_CASES)
def test_cuda_fused_paged_attn_bitwise(card, case):
    """One launch, no K3 or K2, bitwise equal to K3 + K2 at the first and
    the last layer of both units, on a pool whose free blocks and rows past
    the width are NaN; within bf16's 2e-2 of the plain version."""
    lay, data, table, q = _k11_pool(card, case, sum(case))
    for unit in (0, 1):
        for layer in (0, case[-1] - 1):
            kw = _k11_kwargs(lay, unit, layer)
            ops.reset_launches()
            got = ishmem_device.paged_flash_attention(data, table, q, **kw)
            assert {k: n for k, n in ops.LAUNCHES.items() if n} == \
                {"fused_paged_attn": 1}
            want = _k11_composition(data, table, q, lay, unit, layer)
            torch.cuda.synchronize()
            assert bool(got.isfinite().all())
            assert torch.equal(got, want)
    plain = ishmem_device.fused_paged_attn_plain(data, table, q, **kw)
    torch.testing.assert_close(got.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


def test_cuda_fused_paged_attn_waits_on_signal_words(card):
    """Words already at (or past) their values let the kernel through, and
    the output is the same bits as with no words."""
    lay, data, table, q = _k11_pool(card, K11_CASES[1], 5)
    kw = _k11_kwargs(lay, 1, 2)
    words = torch.tensor([3, 5], dtype=torch.int32, device=card)
    got = ishmem_device.paged_flash_attention(
        data, table, q, signals=[(words[0:1], 3), (words[1:2], 4)], **kw)
    assert torch.equal(got, ishmem_device.paged_flash_attention(
        data, table, q, **kw))


def test_cuda_fused_paged_attn_routes_by_dtype(card):
    """Through ``fused_paged_attn`` on a card heap: a bf16 pool and q launch
    K11 once, bitwise the composition; a cast through ``dtype`` or an f32
    pool keeps K3 + K2."""
    from repro_torch.core import context, device as device_mod
    from repro_torch.serve.paged_attn import PagedDecodeView
    lay, data, table, q = _k11_pool(card, K11_CASES[2], 6)
    R = data.shape[0]
    tables = {s: [int(b) for b in table[s] if b < R] for s in (0, 1)}
    composed = {"paged_gather": 1, "flash_attention": 1}
    for pool_dt, cast, launched in (
            (torch.bfloat16, None, {"fused_paged_attn": 1}),
            (torch.bfloat16, torch.float32, composed),
            (torch.float32, None, composed)):
        ctx, heap = context.init(npes=2, node_size=2, heap_words=1 << 21,
                                 device=card)
        name = str(pool_dt).removeprefix("torch.")
        ptr, sig = heap.calloc((data.numel(),), name), \
            heap.calloc((), "int32")
        heap = heap.write(ptr, 1, data.reshape(-1).to(pool_dt))
        heap = heap.write(sig, 1, torch.tensor([1], dtype=torch.int32))
        pool = types.SimpleNamespace(layout=lay, data=ptr, num_blocks=R,
                                     blocks_of=lambda rid: tables[rid])
        view = PagedDecodeView(pool, 1, 3)
        for s in (0, 1):
            heap = view.attach(heap, s, s, fresh_ids=[])
        wg = device_mod.work_group(ctx, size=128, pe=1)
        qq = q.to(cast or pool_dt)
        ops.reset_launches()
        _, got = ishmem_device.fused_paged_attn(
            wg, heap, view, qq, layer=1, waits=[(sig, 1)], dtype=cast)
        assert {k: n for k, n in ops.LAUNCHES.items() if n} == launched
        assert bool(got.isfinite().all())
        if cast is None and pool_dt == torch.bfloat16:
            row = heap.read(ptr, 1).reshape(R, lay.block_words)
            assert torch.equal(got, _k11_composition(row, table, qq, lay,
                                                     0, 1))


def test_cuda_fused_paged_attn_refuses_misaligned_pool(card):
    """TMA reads from 16-byte aligned bases only: a pool row one element
    off the grid raises before any launch."""
    lay, data, table, q = _k11_pool(card, K11_CASES[1], 7)
    flat = torch.zeros(data.numel() + 1, dtype=data.dtype, device=card)
    shifted = flat[1:].view(data.shape)
    before = ops.LAUNCHES["fused_paged_attn"]
    with pytest.raises(ValueError, match="16-byte"):
        ishmem_device.paged_flash_attention(shifted, table, q,
                                            **_k11_kwargs(lay, 0, 0))
    assert ops.LAUNCHES["fused_paged_attn"] == before


# ---------------------------------------------------------------------------
# K4-K8 (moved from tests/test_torch_comms.py)
# ---------------------------------------------------------------------------


def _cuda_inputs(card, dtype, P, n, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(P, n, generator=g, device=card) * 50).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_cuda_copy_kernels_bitwise(card, dtype, P):
    for n in (1, 127, 128 * 40 + 37, 1 << 16):
        x = _cuda_inputs(card, dtype, P, n, n)
        assert torch.equal(rc.ring_allgather(x), rc.ring_allgather_plain(x))
        for root in {0, 3 % P, P - 1}:
            assert torch.equal(rc.push_broadcast(x, root),
                               rc.push_broadcast_plain(x, root))
        for off, w in ((1, 1), (3, 4), (1, 128)):
            assert torch.equal(rma_copy.remote_put(x, target_offset=off,
                                                   work_items=w),
                               rma_copy.remote_put_plain(x, off))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_cuda_allgather_pull_bitwise(card, dtype, P):
    """The pull all-gather: 16-byte vectors where the chunk and base allow,
    narrower units otherwise (odd chunks, a base one element off the
    16-byte grid); every output word overwritten on poisoned memory."""
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        for n in (1, 127, 128 * 40 + 37):
            x = _cuda_inputs(card, dtype, P, n, n)
            assert torch.equal(rc.ring_allgather(x),
                               rc.ring_allgather_plain(x))
            flat = _cuda_inputs(card, dtype, 1, P * n + 1, n)[0]
            x = flat[1:].view(P, n)             # contiguous, base off-grid
            assert x.is_contiguous() and x.data_ptr() % 16
            assert torch.equal(rc.ring_allgather(x),
                               rc.ring_allgather_plain(x))
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_cuda_broadcast_pull_bitwise(card, dtype, P):
    """The fan-out broadcast at every root: 16-byte vectors where the chunk
    and base allow, narrower units otherwise (odd chunks, a base one
    element off the 16-byte grid); every output word overwritten on
    poisoned memory."""
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        for n in (1, 127, 128 * 40 + 37, 1 << 16):
            aligned = _cuda_inputs(card, dtype, P, n, n)
            flat = _cuda_inputs(card, dtype, 1, P * n + 1, n)[0]
            shifted = flat[1:].view(P, n)       # contiguous, base off-grid
            assert shifted.is_contiguous() and shifted.data_ptr() % 16
            for x in (aligned, shifted):
                for root in range(P):
                    assert torch.equal(rc.push_broadcast(x, root),
                                       rc.push_broadcast_plain(x, root))
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()


def test_cuda_launches_run_on_the_callers_stream(card):
    """K1 and K7 called under a side stream launch on it, ordered after a
    producer kernel there: the side stream first sleeps, then fills the
    inputs, so a launch on any other stream would read them unfilled (NaN)
    and differ from the plain versions."""
    gen = torch.Generator(device=card).manual_seed(17)
    n, P, root = 1 << 20, 8, 5
    src_vals = torch.randn(n, generator=gen, device=card).bfloat16()
    x_vals = torch.randn(P, n, generator=gen, device=card).bfloat16()
    src = torch.full_like(src_vals, float("nan"))
    x = torch.full_like(x_vals, float("nan"))
    row = torch.zeros(3 * n, dtype=torch.bfloat16, device=card)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=card)
    before = dict(ops.LAUNCHES)
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)           # tens of milliseconds
        src.copy_(src_vals)                     # the producers
        x.copy_(x_vals)
        stored = rma_copy.copy_into(row, src, n + 3)
        out = rc.push_broadcast(x, root)
    side.synchronize()
    torch.cuda.synchronize()
    want_row = rma_copy.copy_into_plain(torch.zeros_like(row), src_vals,
                                        n + 3)
    assert stored is row and torch.equal(row, want_row)
    assert torch.equal(out, rc.push_broadcast_plain(x_vals, root))
    assert ops.LAUNCHES["copy_into"] == before["copy_into"] + 1
    assert ops.LAUNCHES["push_broadcast"] == before["push_broadcast"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_cuda_reduce_scatter_bitwise(card, dtype, P):
    """The pull kernel in the ring's fold order: 16-byte vectors where the
    chunk and base allow, one element otherwise (odd chunks, and a base
    one element off the 16-byte grid)."""
    for n in (1, 127, 128 * 40 + 37, 1 << 16):
        g = torch.Generator(device=card).manual_seed(n)
        x = torch.randn(P, P, n, generator=g, device=card).to(dtype)
        assert torch.equal(rc.ring_reduce_scatter(x),
                           rc.ring_reduce_scatter_plain(x))
        flat = torch.randn(P * P * n + 1, generator=g, device=card).to(dtype)
        x = flat[1:].view(P, P, n)              # contiguous, base off-grid
        assert x.is_contiguous() and x.data_ptr() % 16
        assert torch.equal(rc.ring_reduce_scatter(x),
                           rc.ring_reduce_scatter_plain(x))
    torch.cuda.synchronize()


def test_cuda_barrier_and_shmem_ops(card):
    for P in (1, 2, 8):
        assert rc.barrier_push(P, device=card).tolist() == [1] * P
    ops.reset_launches()
    shmem, eng = api.get_ops("shmem", npes=NPES), api.get_ops("xla")
    for shape in ((NPES, 64), (NPES, 40, 520)):
        x = torch.randn(*shape, device=card)
        torch.testing.assert_close(shmem.psum(x), eng.psum(x), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(shmem.psum_overlap(x), eng.psum(x),
                                   rtol=1e-5, atol=1e-5)
    assert all(ops.LAUNCHES[k] for k in ("remote_put", "ring_allgather",
                                         "ring_reduce_scatter"))


def test_cuda_barrier_epochs(card):
    """K8 keeps its counters across calls under an epoch: ones over 10,000
    back-to-back barriers at every P in 1-8, over calls whose P changes
    each time, and on a second stream beside the first."""
    for P in range(1, 9):
        outs = [rc.barrier_push(P, device=card) for _ in range(10_000)]
        assert bool((torch.stack(outs) == 1).all()), P
    outs = [rc.barrier_push(1 + i % 8, device=card) for i in range(2000)]
    assert bool((torch.cat(outs) == 1).all())
    side = torch.cuda.Stream(device=card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        beside = [rc.barrier_push(8, device=card) for _ in range(2000)]
    main = [rc.barrier_push(8, device=card) for _ in range(2000)]
    torch.cuda.synchronize()
    assert bool((torch.stack(beside + main) == 1).all())
    index = torch.cuda.current_device()
    assert len([k for k in rc._BARRIERS if k[0] == index]) >= 2


# ---------------------------------------------------------------------------
# K9 and K10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_cuda_reduce_tile_bitwise(card, dtype, op):
    g = torch.Generator(device=card).manual_seed(9)
    scale = 3 if op == "prod" else 50
    for T in (1, 2, 5, 8):
        for N in (128, 640, 1024):
            x = (torch.randn(T, N, generator=g, device=card) * scale).to(dtype)
            assert torch.equal(rt.reduce_tile(x, op),
                               rt.reduce_tile_plain(x, op))
    # a base pointer off the 16-byte grid takes the one-element path
    flat = (torch.randn(3 * 640 + 1, generator=g, device=card)
            * scale).to(dtype)
    x = flat[1:].view(3, 640)
    assert torch.equal(rt.reduce_tile(x, op), rt.reduce_tile_plain(x, op))


K10_SHAPES = [
    (64, 64, 0, 0, 4, 128),          # diagonal shard
    (100, 37, 50, 10, 2, 64),        # past shard, ragged tiles
    (37, 100, 0, 20, 3, 128),        # some rows see no key
    (128, 128, 0, 128, 2, 128),      # a future shard: every row masked
    (96, 160, 64, 0, 2, 64),
    (1, 1, 0, 0, 1, 128),            # one query, one key
    (65, 33, 33, 0, 2, 128),         # Sq = 64 + 1, Skv = 32 + 1
    (63, 31, 31, 0, 2, 64),          # one short of the tiles
    (70, 45, 200, 100, 3, 128),      # Skv not a multiple of 8, past shard
    (130, 257, 300, 0, 2, 64),       # Skv = 8 * 32 + 1
    (200, 200, 0, 0, 2, 128),        # diagonal, ragged q and key tiles
    (64, 64, 0, 0, 4, 32),           # hd 32: the launcher's ring demo
    (100, 37, 50, 10, 2, 32),
    (37, 100, 0, 20, 3, 32),
    (64, 64, 0, 0, 4, 80),           # hd 80: tiles padded to 96 columns
    (100, 37, 50, 10, 2, 80),
    (37, 100, 0, 20, 3, 80),
    (130, 257, 300, 0, 2, 80),
]


def _k10_inputs(card, dtype, Sq, Skv, H, hd, seed=None):
    rng = np.random.default_rng(Sq + Skv if seed is None else seed)
    return tuple(torch.from_numpy(rng.normal(size=(1, S, H, hd)).astype(
        np.float32)).to(card, getattr(torch, dtype)) for S in (Sq, Skv, Skv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_off,k_off,H,hd", K10_SHAPES)
def test_cuda_flash_partial(card, dtype, Sq, Skv, q_off, k_off, H, hd):
    q, k, v = _k10_inputs(card, dtype, Sq, Skv, H, hd)
    got = ishmem_device.flash_partial(q, k, v, q_off=q_off, k_off=k_off)
    want = ishmem_device.flash_partial_plain(q, k, v, q_off=q_off,
                                             k_off=k_off)
    # the partials' arithmetic is f32 whatever the input type
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL["float32"],
                                   rtol=TOL["float32"])
    blind = (q_off + torch.arange(Sq, device=card)) < k_off
    assert bool((got[1][:, blind] == flash_attn.NEG_INF).all())
    assert bool((got[2][:, blind] == Skv).all())
    torch.testing.assert_close(
        ishmem_device.merge_partials([got]),
        ishmem_device.merge_partials([want]), atol=TOL["float32"],
        rtol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_partial_refuses_hd96(card, dtype):
    """K10's kernels exist at head dims 32, 64, 80 and 128 only: head dim
    96 raises before any launch."""
    q, k, v = _k10_inputs(card, dtype, 16, 16, 2, 96)
    ops.reset_launches()
    with pytest.raises(ValueError, match="head_dim 96"):
        ishmem_device.flash_partial(q, k, v, q_off=0, k_off=0)
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,hd", [(37, 100, 3, 128), (100, 37, 2, 64),
                                         (1, 1, 1, 64), (130, 257, 2, 128),
                                         (37, 100, 3, 32), (130, 257, 2, 80),
                                         (1, 1, 1, 80)])
def test_cuda_flash_partial_split_bitwise(card, dtype, Sq, Skv, H, hd):
    """The split pass against its plain version: the TF32 hi/lo planes of
    q * hd**-0.5 and k, and V^T in KEY_ORDER with zero keys to Skv8."""
    q, k, v = _k10_inputs(card, dtype, Sq, Skv, H, hd)
    q, k, v = (torch.cat([t, t * 3]) for t in (q, k, v))      # B = 2
    got = ishmem_device.flash_partial_split(q, k, v)
    want = ishmem_device.flash_partial_split_plain(q, k, v)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_off,k_off,H,hd", [
    (200, 200, 0, 0, 2, 128), (37, 100, 0, 20, 3, 64),
    (96, 70, 0, 64, 2, 128), (200, 200, 0, 0, 2, 32), (96, 70, 0, 64, 2, 80)])
def test_cuda_flash_partial_run_to_run(card, dtype, Sq, Skv, q_off, k_off,
                                       H, hd):
    """Bitwise run to run; rows that see no key exactly m = -1e30, l = Skv;
    batch 0 of B = 2 bitwise equal to B = 1."""
    q, k, v = _k10_inputs(card, dtype, Sq, Skv, H, hd, seed=3)
    first = ishmem_device.flash_partial(q, k, v, q_off=q_off, k_off=k_off)
    again = ishmem_device.flash_partial(q, k, v, q_off=q_off, k_off=k_off)
    pair = ishmem_device.flash_partial(
        *(torch.cat([t, t.flip(1)[:, :t.shape[1]]]) for t in (q, k, v)),
        q_off=q_off, k_off=k_off)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, pair):
        assert torch.equal(a, b) and torch.equal(a, c[:1])
    blind = (q_off + torch.arange(Sq, device=card)) < k_off
    assert bool((first[1][:, blind] == flash_attn.NEG_INF).all())
    assert bool((first[2][:, blind] == Skv).all())


# ---------------------------------------------------------------------------
# the serving modes on the card, at reduced widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,gather", [
    (["--stream-chunks", "2"], True), (["--shared-prefix"], True),
    (["--dense-rehydrate"], False)])
def test_cuda_serving_modes_match_single_pe(card, tmp_path, flags, gather):
    """Streamed, prefix-shared (a 20-token prompt over blocks of 8: the
    first decode write copies the boundary block) and dense-rehydrated
    serving on the card: every request bitwise equal to the single-PE
    baseline at the same shapes, K1 and K2 launched, K3 launched except in
    the dense mode, and the trace valid."""
    trace = tmp_path / "trace.json"
    ops.reset_launches()
    sched = serve.main(["--disagg", "--device", "cuda", "--requests", "6",
                        "--prompt-len", "20", "--max-new", "5", "--slots",
                        "2", "--block-tokens", "8", "--kv-blocks", "48",
                        "--trace", str(trace)] + flags)
    launches = dict(ops.LAUNCHES)
    assert launches["copy_into"] and launches["flash_attention"]
    assert bool(launches["paged_gather"]) == gather
    st = sched.stats
    assert (st.admissions, st.evictions) == (6, 6)
    if "--shared-prefix" in flags:
        assert (st.prefix_hits, st.cow_copies) == (5, 6)
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot)
    assert validate(json.loads(trace.read_text())) == []


@pytest.mark.parametrize("arch,flags", [
    ("zamba2-2.7b", []), ("zamba2-2.7b", ["--fused-attn"]),
    ("xlstm-125m", [])])
def test_cuda_recurrent_families_match_single_pe(card, arch, flags):
    """Zamba2 (Mamba2 and the shared attention block, whose K/V is paged)
    and xLSTM (a tail-only layout) served disaggregated at reduced widths:
    every request bitwise equal to the single-PE baseline, K1 launched, K2
    and K3 only where the layout pages K/V."""
    ops.reset_launches()
    sched = serve.main(["--disagg", "--device", "cuda", "--arch", arch,
                        "--requests", "5", "--prompt-len", "20",
                        "--max-new", "5", "--slots", "2", "--block-tokens",
                        "8", "--kv-blocks", "48"] + flags)
    launches = dict(ops.LAUNCHES)
    paged = bool(sched.pool.layout.paged)
    assert paged == (arch == "zamba2-2.7b")
    assert launches["copy_into"]
    assert bool(launches["flash_attention"]) == paged
    assert bool(launches["paged_gather"]) == paged
    assert (sched.stats.admissions, sched.stats.evictions) == (5, 5)
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot)


# (arch, layers kept): 2 of each, 1 of arctic (27 GB of experts a layer),
# 5 of the vision model (one unit: its cross-attention layer is the 5th)
REMAINING = [("minitron-8b", 2), ("h2o-danube-3-4b", 2), ("starcoder2-7b", 2),
             ("llama4-scout-17b-a16e", 2), ("arctic-480b", 1),
             ("whisper-medium", 2), ("llama-3.2-vision-90b", 5)]


def _serve_cut(arch, layers, argv):
    """Serve ``arch`` at its published widths cut to ``layers``, through
    ``serve._build_disagg``, as ``chip_smoke.py`` does."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model
    args = serve.parse_args(argv)
    cfg = dataclasses.replace(cfgbase.get_config(arch), num_layers=layers)
    params = model.init_params(cfg, seed=0, device="cuda")
    sched = serve._build_disagg(args, cfg, params)
    sched.run()
    return sched


@pytest.mark.parametrize("arch,layers", REMAINING)
def test_cuda_remaining_families_match_single_pe(card, arch, layers):
    """The seven remaining configurations at their published widths, bf16,
    depth cut, served disaggregated (danube at 4100-token prompts, so its
    cache is a ring of 4096; whisper and the vision model with their
    embeddings): every request bitwise equal to the single-PE baseline, K1
    and K3 launched, K2 everywhere but under danube's window."""
    ring = arch.startswith("h2o")
    S, n, blocks = (4100, 3, 3 * 256) if ring else (20, 5, 48)
    ops.reset_launches()
    sched = _serve_cut(arch, layers, [
        "--disagg", "--full", "--arch", arch, "--requests", str(n),
        "--prompt-len", str(S), "--max-new", "5", "--slots", "2",
        "--kv-blocks", str(blocks)])
    launches = dict(ops.LAUNCHES)
    assert sched.pool.layout.ring == ring
    assert launches["copy_into"] and launches["paged_gather"]
    assert bool(launches["flash_attention"]) == (not ring)
    assert (sched.stats.admissions, sched.stats.evictions) == (n, n)
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot)


def test_cuda_ring_tails_carry_nan_bits(card):
    """Reduced h2o-danube (window 64) at 40-token prompts and a 70-token
    cache: the ring's 24 empty slots hold kpos -1, a NaN bit pattern in
    the f32 tail, through K1, the pool stores and the unpack; decode wraps
    into slot 0.  Tokens bitwise the single-PE baseline, and every slot's
    tail bitwise the packed tail of its last request."""
    from repro_torch.serve import kvpool
    sched = serve.main(["--disagg", "--device", "cuda", "--arch",
                        "h2o-danube-3-4b", "--requests", "4", "--prompt-len",
                        "40", "--max-new", "30", "--slots", "2",
                        "--block-tokens", "8", "--kv-blocks", "48"])
    lay = sched.pool.layout
    assert lay.ring and lay.cache_width == 64
    tally = sched.stats.decode_graph    # kpos rides in the graph's inputs
    assert tally.captures == 1 and tally.replays and not tally.eager_steps
    last = {}
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot)
        key = (req.decode_pe, req.slot)
        if key not in last or req.admit_step > last[key].admit_step:
            last[key] = req
    for (pe, slot), req in last.items():
        _, _, cache1 = sched.engine.prefill_request(req.batch)
        want = kvpool.pack_tail(lay, cache1)
        got = sched.migrator.gather_tail(sched.heap, slot, pe)
        assert int(want.isnan().sum()) == 2 * 24
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the decode step replayed as CUDA graphs (models/decode_graph.py)
# ---------------------------------------------------------------------------


def _stepped(sched):
    """Step ``sched`` to its end; returns every pool after every step and
    every decode step's logits."""
    from repro_torch.models import model
    step, logits, pools = model.decode_step, [], []

    def recorded(*a, **kw):
        out = step(*a, **kw)
        logits.append(out[0].clone())
        return out

    model.decode_step = recorded
    try:
        while not sched.done():
            sched.step()
            pools.append({dt: pool.clone()
                          for dt, pool in sched.heap.pools.items()})
    finally:
        model.decode_step = step
    return pools, logits


def _single_pe(sched, slots=2):
    """Each request's tokens against ``Engine.generate_in_slot``."""
    for req in sched.requests.values():
        assert req.out == sched.engine.generate_in_slot(
            req.batch, dataclasses.replace(sched.scfg,
                                           max_new_tokens=req.max_new),
            num_slots=slots, slot=req.slot), req.rid


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite"])
def test_cuda_decode_graph_is_bitwise_the_eager_step(card, arch, temperature,
                                                     monkeypatch):
    """Reduced qwen3-4b and DeepSeek-V2-Lite served disaggregated over 24
    requests (admissions, evictions and copy-on-write mid-flight, 40 steps
    and more), once with every paged step eager and once replayed as
    graphs: every step's logits and pools and every token bitwise equal,
    greedy and sampled from the same seeded generators; one capture, a
    replay a PE step.  Greedy, every request is bitwise the single-PE
    dense baseline."""
    from _torch_decode_traffic import build
    from repro_torch.models import decode_graph
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "eager_reason", lambda *a: "eager")
        eager = build(arch, "cuda", requests=24, temperature=temperature)
        want_pools, want_logits = _stepped(eager)
    sched = build(arch, "cuda", requests=24, temperature=temperature)
    pools, logits = _stepped(sched)
    st, tally = sched.stats, sched.stats.decode_graph
    assert st.decode_steps >= 40 and st.cow_copies > 0
    assert st.admissions == st.evictions == 24
    assert (tally.captures, tally.replays, tally.eager_steps) == \
        (1, len(logits), {})
    assert eager.stats.decode_graph.eager_steps == {"eager": len(logits)}
    assert len(logits) == len(want_logits) and len(pools) == len(want_pools)
    for got, want in zip(logits, want_logits):
        assert torch.equal(got, want)
    for got, want in zip(pools, want_pools):
        for dt, pool in got.items():
            assert torch.equal(pool, want[dt]), dt
    for rid, req in sched.requests.items():
        assert req.out == eager.requests[rid].out
    if temperature == 0.0:
        _single_pe(sched)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite"])
def test_cuda_decode_graph_under_a_profiler_and_a_wall_tracer(card, arch):
    """The same run with nothing recording, and with a wall-clocked tracer
    and a recording profiler (from after the capture): equal tokens and
    tally.  The tracer's ``decode_graph`` counter ends at the tally; a
    latent-attention model's parts record as spans inside ``decode.model``
    and as ranges with device time, and its routing as ``moe`` counters."""
    from _torch_decode_traffic import build
    from repro_torch.obs.tracer import SpanTracer, WallClock
    plain = build(arch, "cuda", requests=8)
    plain.run()
    sched = build(arch, "cuda", requests=8)
    tracer = sched.ctx.tracer = SpanTracer(clock=WallClock())
    while not sched.stats.decode_graph.captures:
        sched.step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        while not sched.done():
            sched.step()
        torch.cuda.synchronize()
    for rid, req in sched.requests.items():
        assert req.out == plain.requests[rid].out
    tally = sched.stats.decode_graph
    assert tally == plain.stats.decode_graph and tally.captures == 1
    counts = [ev.args for ev in tracer.events
              if ev.ph == "C" and ev.name == "decode_graph"]
    assert counts and counts[-1] == tally.counter()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels
    names = {ev.name for ev in tracer.events if ev.ph == "B"}
    if arch == "deepseek-v2-lite":
        assert {"decode.mla", "decode.moe"} <= names
        ranges = {e.name: e for e in kernels
                  if e.name in ("decode.mla", "decode.moe")}
        assert set(ranges) == {"decode.mla", "decode.moe"}
        moe = [ev.args for ev in tracer.events
               if ev.ph == "C" and ev.name == "moe"]
        assert all(c["dropped"] == 0 for c in moe)
        decode = [c for c in moe if c["tokens"] == 2]     # the bank's rows
        assert decode and all(1 <= c["max_per_expert"] <= 2 for c in decode)
    else:
        assert not {"decode.mla", "decode.moe"} & names


# ---------------------------------------------------------------------------
# decode attention over the gathered block payload (kernels/decode_attn.py)
# ---------------------------------------------------------------------------

# (B, nb, T, nkv, q_per_kv, hd): cell 1's bank (8 rows over 76 blocks of 16,
# qwen3-4b's 8 KV heads of 4 queries at hd 128), starcoder2's ratio 9,
# h2o-danube's hd 120, zamba2's hd 80 and whisper's hd 64 (both MHA)
DECODE_SHAPES = [(8, 76, 16, 8, 4, 128), (3, 10, 16, 4, 9, 128),
                 (3, 9, 16, 8, 4, 120), (3, 33, 16, 32, 1, 80),
                 (3, 27, 16, 16, 1, 64)]


def _kv_views(payload, T, nkv, hd):
    """The K and V views of a block payload of three repeats of two leaves,
    repeat 1 of each, as ``KVLayout.leaf_view`` cuts them."""
    views = payload.unflatten(2, (2, 3, T, nkv, hd))[:, :, :, 1]
    return views[:, :, 0], views[:, :, 1]


def _decode_case(card, B, nb, T, nkv, g, hd, seed=0):
    """q, a block payload (``_kv_views``), rows of mixed length (the last
    position, the first, one past the cache, the rest drawn) and new
    columns."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=card).bfloat16()

    W = nb * T
    pos = torch.randint(0, W, (B,), generator=gen, device=card)
    pos[:3] = torch.tensor([W - 1, 0, W + 3])
    return (draw(B, 1, nkv * g, hd), draw(B, nb, 2 * 3 * T * nkv * hd), pos,
            draw(B, 1, nkv, hd), draw(B, 1, nkv, hd))


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("B,nb,T,nkv,g,hd", DECODE_SHAPES)
def test_cuda_decode_attention(card, B, nb, T, nkv, g, hd, store):
    """The kernel against its plain version to the bf16 tolerance over the
    payload view, the stored columns bitwise; bitwise run to run and
    between the dense cache and the payload view of the same positions.
    With a store, bitwise the kernel without one over the cache that
    already holds the new columns: the new column is the one attended."""
    from repro_torch.kernels import decode_attn
    q, payload, pos, k_new, v_new = _decode_case(card, B, nb, T, nkv, g, hd)
    new = (k_new, v_new) if store else (None, None)
    runs = []
    for _ in range(2):
        k, v = _kv_views(payload.clone(), T, nkv, hd)
        ops.reset_launches()
        runs.append((decode_attn.decode_attention(q, k, v, pos, *new), k, v))
        assert ops.LAUNCHES["decode_attention"] == 1
    k, v = _kv_views(payload.clone(), T, nkv, hd)
    want = decode_attn.decode_attention_plain(q, k, v, pos, *new)
    kd, vd = (t.flatten(1, 2).contiguous()
              for t in _kv_views(payload, T, nkv, hd))
    dense = decode_attn.decode_attention(q, kd, vd, pos, *new)
    torch.cuda.synchronize()
    got, kg, vg = runs[0]
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert torch.equal(kg, k) and torch.equal(vg, v)
    assert torch.equal(kd, k.flatten(1, 2)) and torch.equal(vd, v.flatten(1, 2))
    assert torch.equal(got, runs[1][0]) and torch.equal(got, dense)
    if store:
        held = decode_attn.decode_attention(q, kg, vg, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, held)


@pytest.mark.parametrize("B,nb,T,nkv,g,hd", DECODE_SHAPES[:2])
def test_cuda_decode_attention_rows_depend_on_their_own_inputs(
        card, B, nb, T, nkv, g, hd):
    """Each row of a bank, moved to another index of a bank of another
    size (and another block count) among other rows, gives bitwise the
    same output and stores the same column."""
    from repro_torch.kernels import decode_attn
    q, payload, pos, k_new, v_new = _decode_case(card, B, nb, T, nkv, g, hd)
    pos = pos.clamp(max=nb * T - 1)      # the same live rows in either bank
    B2, nb2 = B + 3, nb + 2
    q2, payload2, pos2, kn2, vn2 = _decode_case(card, B2, nb2, T, nkv, g, hd,
                                                seed=1)
    rows = torch.randperm(B2, device=card)[:B]
    q2[rows], pos2[rows], kn2[rows], vn2[rows] = q, pos, k_new, v_new
    payload2[rows, :nb] = payload
    k, v = _kv_views(payload, T, nkv, hd)
    got = decode_attn.decode_attention(q, k, v, pos, k_new, v_new)
    k2, v2 = _kv_views(payload2, T, nkv, hd)
    got2 = decode_attn.decode_attention(q2, k2, v2, pos2, kn2, vn2)
    torch.cuda.synchronize()
    assert torch.equal(got2[rows], got)
    assert torch.equal(k2[rows, :nb], k) and torch.equal(v2[rows, :nb], v)


def test_cuda_decode_attention_refuses_what_the_kernel_cannot_take(card):
    from repro_torch.kernels import decode_attn
    q, payload, pos, _, _ = _decode_case(card, 3, 4, 16, 2, 4, 64)
    kp, vp = _kv_views(payload, 16, 2, 64)
    ops.reset_launches()
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q.float(), kp.float(), vp.float(), pos)
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q, kp, vp, pos.float())
    odd = torch.zeros(3, 4, 16, 2, 68, dtype=torch.bfloat16,
                      device=card)[..., 1:65]
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q, odd, odd, pos)
    assert ops.LAUNCHES["decode_attention"] == 0


def test_cuda_payload_form_is_bitwise_the_leaf_form_and_the_eager_step(
        card, monkeypatch):
    """Reduced qwen3-4b with a bf16 cache, 4 query heads a KV head at hd
    128, over 24 requests with admissions, evictions and copy-on-write: in
    payload form, replayed as graphs, every step's logits and pools and
    every token bitwise the leaf form's and the eager payload step's; the
    kernel launches once a layer a PE step, the replays counted; greedy,
    every request is its single-PE dense baseline."""
    from _torch_decode_traffic import build
    from repro_torch.models import decode_graph
    from repro_torch.serve.paged_attn import PagedDecodeView
    gqa = dict(dtype="bfloat16", param_dtype="bfloat16", num_heads=8,
               num_kv_heads=2, head_dim=128)
    runs = {}
    for name in ("leaf", "eager", "payload"):
        with monkeypatch.context() as m:
            if name == "leaf":
                m.setattr(PagedDecodeView, "form", lambda self: "layout")
            if name == "eager":
                m.setattr(decode_graph, "eager_reason", lambda *a: "eager")
            sched = build("qwen3-4b", "cuda", requests=24, **gqa)
            ops.reset_launches()
            runs[name] = (sched, *_stepped(sched), dict(ops.LAUNCHES))
    sched, pools, logits, launches = runs["payload"]
    st = sched.stats
    assert st.cow_copies > 0 and st.admissions == st.evictions == 24
    assert st.paged_decode.payload_steps == len(logits) >= 40
    assert st.decode_graph.captures == 1
    # two layers a step, and the capture's warm-up step once, eagerly
    assert launches["decode_attention"] == 2 * (len(logits) + 1)
    assert runs["leaf"][0].stats.paged_decode.leaf_steps == {
        "layout": len(logits)}
    for name in ("leaf", "eager"):
        other, want_pools, want_logits, _ = runs[name]
        assert len(want_logits) == len(logits)
        for got, want in zip(logits, want_logits):
            assert torch.equal(got, want), name
        for got, want in zip(pools, want_pools):
            for dt, pool in got.items():
                assert torch.equal(pool, want[dt]), (name, dt)
        for rid, req in sched.requests.items():
            assert req.out == other.requests[rid].out
    _single_pe(sched)


def test_cuda_decode_graph_captures_again_for_another_bank(card):
    """One engine serving banks of 2 then of 3 slots: a graph each, each
    captured once, and every request bitwise its single-PE baseline."""
    from _torch_decode_traffic import build
    two = build("qwen3-4b", "cuda", requests=6, slots=2)
    two.run()
    three = build("qwen3-4b", "cuda", requests=6, slots=3)
    three.engine = two.engine
    three.run()
    assert len(two.engine._graphs) == 2
    for sched in (two, three):
        tally = sched.stats.decode_graph
        assert tally.captures == 1 and tally.replays > 0
        assert not tally.eager_steps
    _single_pe(two)
    _single_pe(three, slots=3)


# ---------------------------------------------------------------------------
# the fleet: cross-pod migration, preemption, chaos (ROADMAP item 10)
# ---------------------------------------------------------------------------


def _cut_qwen(layers):
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model
    cfg = dataclasses.replace(cfgbase.get_config("qwen3-4b"),
                              num_layers=layers)
    return cfg, model.init_params(cfg, seed=0, device="cuda")


def test_cuda_fleet_full_width_two_layers_match_single_pe(card):
    """The fleet at qwen3-4b's published widths, 2 of 36 layers, bf16: 2
    pods, SLO admission with preemption, affinity routing, 64-token
    prompts; every completed request bitwise equal to
    ``Engine.generate_in_slot`` for its prompt and budget, K1-K3
    launched, the pool drained."""
    cfg, params = _cut_qwen(2)
    args = serve.parse_args([
        "--fleet", "--full", "--pods", "2", "--slots", "2", "--kv-blocks",
        "64", "--block-tokens", "16", "--prompt-len", "64", "--max-new",
        "8", "--rate", "1.2", "--fleet-steps", "12", "--stream-chunks", "0",
        "--seed", "1"])
    fleet, specs = serve._build_fleet(args, cfg, params)
    ops.reset_launches()
    rep = fleet.run(specs)
    launches = dict(ops.LAUNCHES)
    assert all(launches[k] for k in ("copy_into", "flash_attention",
                                     "paged_gather"))
    assert rep["completed"] + rep["shed"] == rep["offered"] > 0
    n = 0
    for pod in fleet.pods:
        for req in pod.sched.requests.values():
            if req.state == "finished":
                assert req.out == pod.sched.engine.generate_in_slot(
                    req.batch, dataclasses.replace(
                        pod.sched.scfg, max_new_tokens=req.max_new),
                    num_slots=2, slot=req.slot)
                n += 1
    assert n == rep["completed"]
    assert fleet.pool.stats()["blocks_in_use"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_cuda_scramble_rows_bitwise(card, dtype):
    """``scramble_rows`` poisons a CUDA pool's dead rows on the card with
    the CPU pool's bits (NaN 0x7FC00000 / 0x7FC0, ``iinfo.min + 1``) and
    leaves the live rows' bits alone."""
    from repro_torch.core import heap as heap_mod
    from repro_torch.serve.fault import scramble_rows
    vals = (torch.randn(4, 300) * 50).to(getattr(torch, dtype))
    heaps = []
    for dev in ("cpu", "cuda"):
        heap = heap_mod.create(4, device=dev)
        ptr = heap.malloc((300,), dtype)
        for pe in range(4):
            heap = heap.write(ptr, pe, vals[pe])
        heaps.append(scramble_rows(heap, [1, 3]).pools[dtype])
    bits = {2: torch.int16, 4: torch.int32}[heaps[0].element_size()]
    assert heaps[1].is_cuda
    assert torch.equal(heaps[0].view(bits), heaps[1].cpu().view(bits))
    assert torch.equal(heaps[1][[0, 2], :300].cpu().view(bits),
                       vals[[0, 2]].view(bits))


def test_cuda_cross_pod_try_admit_fused_through_k11(card):
    """A fused migration across pods (published widths, 2 layers, bf16):
    ``try_admit_fused`` drains the request's queue prefix through the
    host-proxy ring, then K11 waits on the slot's signal for every wire
    block and attends in one launch, bitwise ``assemble`` + K2."""
    from repro_torch.core import device as device_mod
    from repro_torch.serve.kvxfer import expected_signal
    from repro_torch.serve.paged_attn import PagedDecodeView
    cfg, params = _cut_qwen(2)
    args = serve.parse_args([
        "--disagg", "--full", "--fused-attn", "--cross-pod", "--requests",
        "1", "--prompt-len", "64", "--max-new", "4", "--kv-blocks", "32",
        "--slots", "3", "--block-tokens", "16", "--admit-delay", "8"])
    sched = serve._build_disagg(args, cfg, params)
    sched.step()                # prefill, stage, migrate: admission waits
    req = sched.migrating[0]
    px = sched.migrator.proxy
    assert len(sched.ctx.pending) and not px.ring.delivered
    heap, hdr, resident = sched.migrator.try_admit_fused(
        sched.heap, req.slot, req.decode_pe, req.wire_blocks)
    assert hdr["req_id"] == req.rid and resident == req.wire_blocks > 0
    assert len(px.ring.delivered) == req.wire_blocks + 2
    pool = sched.pool
    view = PagedDecodeView(pool, req.decode_pe, 3)
    heap = view.attach(heap, req.slot, req.rid, fresh_ids=[])
    leaf = next(x for x in pool.layout.paged if x.key == "k")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(3, leaf.width, cfg.num_heads, leaf.hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    wg = device_mod.work_group(sched.ctx, pe=req.decode_pe)
    ops.reset_launches()
    heap, got = ishmem_device.fused_paged_attn(
        wg, heap, view, q, waits=[(pool.sig_ptr(req.slot),
                                   expected_signal(req.wire_blocks))])
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == \
        {"fused_paged_attn": 1}
    blk = view.assemble(heap, sched.banks[req.decode_pe].cache)["blocks"][
        leaf.unit_idx]
    want = flash_attn.flash_attention(q, blk["k"][0].contiguous(),
                                      blk["v"][0].contiguous())
    assert torch.equal(got, want) and bool(got.isfinite().all())


# ---------------------------------------------------------------------------
# training: the data-parallel gradient reduce through K4-K6
# ---------------------------------------------------------------------------


def _train_cfg(layers, dtype="bfloat16"):
    from repro_torch.configs import base as cfgbase
    return dataclasses.replace(cfgbase.get_config("qwen3-4b"),
                               num_layers=layers, dtype=dtype,
                               param_dtype=dtype)


def _train_batch(cfg, B, S, device):
    from repro_torch.data.pipeline import DataConfig, TokenStream
    return TokenStream(DataConfig(cfg.vocab_size, S, B, seed=0),
                       device=device).batch(0)


def _rel_l2(a, b):
    den = float(torch.linalg.vector_norm(b.float()))
    return float(torch.linalg.vector_norm(a.float() - b.float())) / den \
        if den else float(torch.linalg.vector_norm(a.float()))


def test_cuda_dp_step_full_width_one_layer(card):
    """qwen3-4b's published widths, 1 layer, bf16, 4 PEs of 2 sequences of
    128 tokens: one data-parallel gradient launches K4 for the 5 norm
    leaves (3 puts each) and K6 + K5 for the 9 matrices, and the reduced
    mean is within 2e-2 (relative L2 per leaf) of one backward on the
    whole batch."""
    from repro_torch.models import model
    from repro_torch.train import train_step as ts
    cfg = _train_cfg(1)
    params = model.init_params(cfg, seed=0, device="cuda")
    batch = _train_batch(cfg, 8, 128, "cuda")
    ops.reset_launches()
    metrics, mean = ts.dp_grads(params, cfg, batch, api.get_ops("shmem",
                                                                npes=4))
    launches = dict(ops.LAUNCHES)
    assert (launches["remote_put"], launches["ring_reduce_scatter"],
            launches["ring_allgather"]) == (15, 9, 9)
    assert not any(launches[k] for k in ("copy_into", "flash_attention",
                                         "paged_gather", "fused_paged_attn",
                                         "flash_partial"))
    loss, _, single = ts.value_and_grad(params, cfg, batch)
    assert abs(float(metrics["loss"]) - float(loss)) < 2e-2 * float(loss)
    for a, b in zip(mean, single):
        assert a.dtype == torch.bfloat16 and _rel_l2(a, b) <= 2e-2


def test_cuda_train_loss_matches_cpu(card):
    """``train_loss`` and its gradients on the card against the plain CPU
    run of the same bf16 weights and batch (reduced qwen3-4b): loss within
    2e-2 relative, every gradient within 6e-2 relative L2 (the port's bf16
    model tolerance, ``tests/test_torch_model.py``)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model
    from repro_torch.train import train_step as ts, tree as tree_mod
    cfg = dataclasses.replace(cfgbase.reduced(cfgbase.get_config("qwen3-4b")),
                              dtype="bfloat16", param_dtype="bfloat16")
    cpu = model.init_params(cfg, seed=2, device="cpu")
    gpu = tree_mod.map_leaves(lambda t: t.to("cuda"), cpu)
    batch = _train_batch(cfg, 4, 64, "cpu")
    lc, _, gc_ = ts.value_and_grad(cpu, cfg, batch)
    lg, _, gg = ts.value_and_grad(gpu, cfg, {k: v.cuda()
                                             for k, v in batch.items()})
    assert abs(float(lg) - float(lc)) <= 2e-2 * abs(float(lc))
    for a, b in zip(gg, gc_):
        assert _rel_l2(a.cpu(), b) <= 6e-2


def test_cuda_resume_equals_uninterrupted(card, tmp_path):
    """Reduced qwen3-4b, bf16, data-parallel over 4 PEs: six steps with a
    checkpoint at 3 against a run resumed from it, bitwise, with PyTorch's
    deterministic algorithms on (the embedding's backward otherwise adds
    with atomics)."""
    import os
    import shutil
    from repro_torch.configs import base as cfgbase
    from repro_torch.train import trainer, tree as tree_mod
    cfg = dataclasses.replace(cfgbase.reduced(cfgbase.get_config("qwen3-4b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              remat=True)
    kw = dict(seq_len=64, global_batch=8, log_every=1, comms_backend="shmem",
              comms_npes=4, device="cuda", ckpt_dir=str(tmp_path))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        a, sa, hist = trainer.train(cfg, trainer.TrainConfig(
            steps=6, ckpt_every=3, **kw), log_fn=lambda *_: None)
        shutil.rmtree(tmp_path / "step_00000006")
        b, sb, hist_b = trainer.train(cfg, trainer.TrainConfig(steps=6, **kw),
                                      resume=True, log_fn=lambda *_: None)
    finally:
        torch.use_deterministic_algorithms(False)
    assert hist_b[0]["step"] == 3 and hist[-1]["loss"] < hist[0]["loss"]
    for x, y in zip(tree_mod.leaves((a, sa)), tree_mod.leaves((b, sb))):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the observability bundle on the card
# ---------------------------------------------------------------------------


def test_cuda_prof_scope_waits_for_the_card(card):
    """A profiler scope's call synchronizes the device of a CUDA tensor:
    the work queued before it has finished when it returns, and the scope
    records one wall-clock sample beside the model's pricing."""
    from repro_torch.core import context
    from repro_torch.obs.prof import Profiler
    ctx, _ = context.init(npes=2, device=card)
    prof = Profiler().attach(ctx)
    a = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    with prof.scope("matmul", nbytes=a.numel() * 4) as ps:
        for _ in range(8):
            b = a @ a
        done.record()
        out = ps({"b": [b]})
        assert done.query()
    assert out["b"][0] is b
    (sample,) = prof.samples
    assert sample.op == "matmul" and sample.wall_s > 0
    assert ctx.telemetry.nsamples("wallclock") == 1


def test_cuda_audit_reads_words_not_pools(card, monkeypatch):
    """A fleet on the card at reduced widths with the auditors every step:
    no violation, and no pass moves more than the signal words it reads to
    the host (every CUDA -> host transfer inside an audit is counted)."""
    from repro_torch.configs import base
    from repro_torch.models import model
    from repro_torch.obs import Obs
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.frontend import Fleet, FleetConfig, TenantSpec, \
        TrafficEngine
    cfg = base.reduced(base.get_config("qwen3-4b"))
    params = model.init_params(cfg, seed=0, device=card)
    eng = Engine(cfg, params, max_len=24, device=params["embed"].device)
    obs = Obs(audit_period=1)
    fleet = Fleet(FleetConfig(max_len=24, max_new=4, stream_chunks=2,
                              num_slots=1, queue_bound=6, kv_blocks=128,
                              router="least_loaded"), engine=eng, obs=obs)
    specs = TrafficEngine(
        [TenantSpec("chat", weight=2.0, prompt_lens=(8,), max_new=(4,),
                    slo="interactive"),
         TenantSpec("scan", weight=1.0, prompt_lens=(12,), max_new=(12,),
                    slo="batch", shared_prefix_prob=1.0, prefix_groups=1)],
        rate=2.0, vocab=cfg.vocab_size, seed=23).schedule(10)
    moved, auditing = [], [False]
    for name in ("cpu", "tolist", "item", "numpy", "to"):
        orig = getattr(torch.Tensor, name)

        def wrap(self, *a, _orig=orig, **k):
            if auditing[0] and self.is_cuda:
                moved.append(self.numel())
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrap)
    audit = obs.auditor.audit

    def counted(f):
        auditing[0] = True
        try:
            return audit(f)
        finally:
            auditing[0] = False
    obs.auditor.audit = counted
    rep = fleet.run(specs, max_steps=2500)
    assert obs.auditor.checks == fleet.elapsed_steps > 0
    assert obs.auditor.violation_count == 0
    assert rep["completed"] + rep["shed"] == rep["offered"]
    words = 2 * (1 + fleet.fcfg.num_slots + fleet.fcfg.max_streams)
    smallest = min(p.numel() for p in fleet.heap.pools.values())
    assert moved and max(moved) <= words * len(fleet.pods) < smallest


@pytest.mark.parametrize("kw", [dict(prompt_len=32),
                                dict(prompt_len=512, full=True,
                                     arch="zamba2-2.7b")])
def test_cuda_seq_parallel_at_hd32_and_hd80(card, kw):
    """``--seq-parallel 4`` at the reference launcher's widths (4 heads of
    32, checked against the plain causal attention, K2 taking no hd 32)
    and at zamba2-2.7b's (32 heads of 80, against K2 in f32): within
    5e-5, through K10."""
    ops.reset_launches()
    rep = serve.seq_parallel_report(4, device=card, **kw)
    assert ops.LAUNCHES["flash_partial"] == rep["partials"] == 10
    assert rep["head_dim"] == (80 if kw.get("full") else 32)
    assert rep["against"] == ("single-PE flash" if kw.get("full")
                              else "plain causal attention")
    assert rep["finite"] and rep["max_abs_err"] <= 5e-5


# ---------------------------------------------------------------------------
# the work counter and the meta route (the dry-run)
# ---------------------------------------------------------------------------


def _charged(fn, *args, **kw):
    from repro_torch.roofline import counter
    with torch.no_grad(), counter.count() as c:
        fn(*args, **kw)
    s = c.summary()
    s.pop("peak_bytes")
    return s


@pytest.mark.parametrize("name", ["flash_attention", "ring_allgather",
                                  "ring_reduce_scatter"])
def test_cuda_kernel_charged_as_its_plain_version(card, name):
    """On the card the counter charges K2, K5 and K6 exactly what their
    plain versions are charged on the CPU, and the launch runs."""
    g = torch.Generator().manual_seed(28)
    if name == "flash_attention":
        x = [torch.randn(1, 512, h, 128, generator=g).bfloat16()
             for h in (32, 8, 8)]
        fn = flash_attn.flash_attention
    elif name == "ring_allgather":
        x, fn = [torch.randn(4, 4096, generator=g).bfloat16()], \
            rc.ring_allgather
    else:
        x, fn = [torch.randn(4, 4, 4096, generator=g)], rc.ring_reduce_scatter
    cpu = _charged(fn, *x)
    ops.reset_launches()
    got = _charged(fn, *[t.to(card) for t in x])
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1
    assert got == cpu and got["by_kernel"][name]["calls"] == 1


def test_cuda_meta_never_reaches_a_launch_and_cuda_never_takes_meta(card):
    """Meta tensors return empty meta outputs with no launch, on a machine
    with the card; a CUDA tensor routes to the kernel, never to meta."""
    ops.reset_launches()
    meta = torch.empty(1, 64, 8, 128, dtype=torch.bfloat16, device="meta")
    out = flash_attn.flash_attention(meta, meta, meta)
    assert out.is_meta and not any(ops.LAUNCHES.values())
    assert rc.ring_allgather(torch.empty(4, 128, device="meta")).is_meta
    assert not any(ops.LAUNCHES.values())
    q = torch.randn(1, 64, 8, 128, device=card).bfloat16()
    assert ops.route(q, q, q) == "cuda"
    with pytest.raises(ValueError):
        ops.route(q, meta)
    out = flash_attn.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert out.is_cuda and ops.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cuda_step_counts_equal_its_dry_run(card, kind):
    """A reduced qwen3-4b step (bf16, so prefill launches K2) on the card
    counts exactly what its meta dry-run record counts."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(cfgbase.reduced(cfgbase.get_config("qwen3_4b")),
                              dtype="bfloat16", param_dtype="bfloat16",
                              head_dim=128, remat=True)
    shape = cfgbase.ShapeSpec("s", kind, 128, 2)
    rec = dryrun.run_one("qwen3_4b", shape, "card", cfg=cfg)
    fn, args = dryrun.build_step(cfg, shape, device=card)
    ops.reset_launches()
    got = _charged(fn, *args)
    torch.cuda.synchronize()
    assert {k: got[k] for k in rec["counted"]} == rec["counted"]
    assert ops.LAUNCHES["flash_attention"] == (cfg.num_layers
                                               if kind == "prefill" else 0)
