"""The port's CUDA kernels against their plain versions, on a card.

Imports no JAX and nothing of the JAX package, so it runs on a machine
that has the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out; the
``cuda`` marker is then unregistered, which only warns).  Without a card
every test here skips.  Data movement (K1, K3-K9) is compared bitwise,
attention (K2, K10) to the reference's tolerances, 2e-5 in f32 and 2e-2 in
bf16; K2's bf16 kernel is also held bitwise to itself run to run and across
batch positions.
"""
import numpy as np
import pytest
import torch

from repro_torch.comms import api
from repro_torch.kernels import flash_attn, ishmem_device, ops, \
    reduce_tile as rt, ring_collectives as rc, rma_copy

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


def _bf16_qkv(card, seed, B, S, H, Hkv, hd):
    return (torch.from_numpy(x).to(card, torch.bfloat16)
            for x in _qkv(seed, B, S, H, Hkv, hd))


@pytest.mark.parametrize("S", [1, 37, 63, 64, 65, 129, 512, 528, 1000])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (8, 8), (8, 1)])
def test_cuda_flash_bf16_grid(card, S, hd, H, Hkv):
    """The wgmma kernel over ragged tiles, both head dims and head ratios
    1:1, 4:1 and 8:1, within bf16's 2e-2 of the plain version."""
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
                                        (1000, 8, 8, 128), (528, 32, 8, 64)])
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
@pytest.mark.parametrize("Sq,Skv,H,hd", [(37, 100, 3, 128), (100, 37, 2, 64),
                                         (1, 1, 1, 64), (130, 257, 2, 128)])
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
    (96, 70, 0, 64, 2, 128)])
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
