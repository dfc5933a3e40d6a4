"""The port's three kernels, held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold those plain versions (and the wrappers' checks and dispatch)
against the reference kernels, run in interpret mode as
``tests/test_kernels.py`` runs them.  Inputs come from numpy seeds and go to
both packages unchanged.  Data movement is compared bitwise; attention to
the reference's own tolerances (2e-5 in f32, 2e-2 in bf16), since the two
sum in different orders.  ``tests/test_torch_cuda.py`` holds the CUDA
kernels against the same plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as ref_flash, ishmem_device as ref_dev
from repro.kernels import ops as ref_ops
from repro_torch import _bridge
from repro_torch.kernels import _build, flash_attn, ishmem_device, ops, \
    rma_copy
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py


def _t(a):
    """A JAX/numpy array as a CPU tensor, bf16 included."""
    return _bridge.array_to_torch(np.asarray(a), "cpu")


def _both(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.fixture
def counts():
    ops.reset_launches()
    yield ops.LAUNCHES
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}, \
        "a CPU tensor launched a kernel"


# ---------------------------------------------------------------------------
# K1: copy_into vs wg_copy_local / copy_into
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,off,w", [
    (128, 0, 1), (256, 128, 2), (1024, 512, 4), (4096, 0, 16),
])
def test_copy_into_matches_wg_copy_sweep(dtype, n, off, w, counts):
    """The grid of test_wg_copy_sweep, bitwise."""
    want = ref_ops.wg_copy_local(jnp.zeros(8192, dtype),
                                 jnp.arange(n).astype(dtype), off,
                                 work_items=w)
    dst = torch.zeros(8192, dtype=getattr(torch, dtype))
    got = rma_copy.copy_into(dst, torch.arange(n).to(dst.dtype), off)
    assert got is dst                         # in place
    assert torch.equal(got, _t(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,off", [(1, 3), (37, 13), (127, 129), (300, 1000),
                                   (128, 64), (1000, 7000)])
def test_copy_into_unaligned_matches_reference(dtype, n, off, counts):
    """Lengths and offsets off the 128 grid, where the reference falls back
    to .at[].set and the port's kernel takes them directly."""
    rng = np.random.default_rng(n * 7919 + off)
    dst = rng.normal(size=8192).astype(np.float32) * 50
    src = rng.normal(size=n).astype(np.float32) * 50
    jd, td = _both(dst, dtype)
    js, ts = _both(src, dtype)
    want = ref_ops.copy_into(jd, js, off)
    assert torch.equal(rma_copy.copy_into(td, ts, off), _t(want))


def test_copy_into_rejects_bad_input(counts):
    row = torch.zeros(256)
    with pytest.raises(IndexError):
        rma_copy.copy_into(row, torch.ones(10), 250)
    with pytest.raises(TypeError):
        rma_copy.copy_into(row, torch.ones(10, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        rma_copy.copy_into(torch.zeros(4, 4), torch.ones(4), 0)
    with pytest.raises(TypeError):
        rma_copy.copy_into(torch.zeros(8, dtype=torch.float64),
                           torch.ones(2, dtype=torch.float64), 0)


# ---------------------------------------------------------------------------
# K2: flash_attention vs flash_attn.flash_attention / ops.flash_attention
# ---------------------------------------------------------------------------


def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,bq,bk", [
    (1, 128, 2, 64, 64, 64),
    (2, 256, 4, 32, 128, 64),
    (1, 512, 1, 128, 256, 256),
])
def test_flash_matches_pallas_kernel(dtype, B, S, H, hd, bq, bk, counts):
    """The grid of test_flash_attention_vs_oracle, equal heads."""
    q, k, v = _qkv(B * S + H, B, S, H, H, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = ref_flash.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = flash_attn.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), _t(want).float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,hd", [(1, 8, 2, 64), (37, 8, 2, 64),
                                        (64, 4, 1, 32), (128, 8, 4, 128),
                                        (45, 10, 2, 128), (64, 14, 2, 128),
                                        (37, 9, 1, 128), (72, 16, 16, 64)])
def test_flash_gqa_matches_ops_flash_attention(dtype, S, H, Hkv, hd, counts):
    """GQA without materialising the repeat, against the reference's
    repeat-then-flash (``ops.flash_attention``), S not a power of two
    included; the serving paths' ratios 5, 7 and 9 (llama4-scout, arctic,
    starcoder2) and whisper's MHA at head dim 64."""
    q, k, v = _qkv(S * 131 + H, 2, S, H, Hkv, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = ref_ops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    got = flash_attn.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(got.float().numpy(), _t(want).float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _wgmma_flash_emulation(q, k, v, tile=128):
    """The bf16 K2 kernel's arithmetic, tile by tile, on the CPU: scores of
    bf16 q and k summed in f32 and then scaled by hd**-0.5 * log2(e), an
    online softmax in f32 (exp2) over key tiles of ``tile`` that stops at
    the diagonal tile (the only one masked), P rounded to bf16 before P.V,
    and ``acc / max(l, 1e-30)`` rounded to bf16 once."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    out = torch.empty(B, H, S, hd)
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(S, q0 + tile))
        m = torch.full((B, H, len(rows), 1), float("-inf"))
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hd)
        for k0 in range(0, q0 + 1, tile):
            keys = torch.arange(k0, min(S, k0 + tile))
            x = (qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)) * scale
            if k0 == q0:
                x = x.masked_fill(keys[None, :] > rows[:, None],
                                  float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.bfloat16().float() @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("B,S,H,Hkv,hd,ref", [
    (1, 128, 2, 2, 64, (64, 64)), (2, 256, 4, 4, 32, (128, 64)),
    (1, 512, 1, 1, 128, (256, 256)),
    (2, 1, 8, 2, 64, None), (2, 37, 8, 2, 64, None), (2, 64, 4, 1, 32, None),
    (2, 128, 8, 4, 128, None), (1, 200, 4, 4, 80, (64, 64)),
    (2, 37, 8, 2, 80, None),
])
def test_flash_bf16_tile_emulation_matches_pallas(B, S, H, Hkv, hd, ref,
                                                  counts):
    """The card kernel's bf16 arithmetic, emulated, is within bf16's 2e-2
    of the Pallas reference on the grids of the two tests above (equal
    heads against ``flash_attn.flash_attention`` with its tile sizes, GQA
    against ``ops.flash_attention``); the emulation runs over several key
    tiles where S allows, with tiles of 64 as well as the kernel's 128."""
    seed = B * S + H if ref else S * 131 + H
    q, k, v = _qkv(seed, B, S, H, Hkv, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "bfloat16") for x in (q, k, v))
    if ref:
        want = ref_flash.flash_attention(jq, jk, jv, block_q=ref[0],
                                         block_k=ref[1])
    else:
        want = ref_ops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    want = _t(want).float().numpy()
    for tile in (64, 128):
        got = _wgmma_flash_emulation(tq, tk, tv, tile=tile)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,bq,bk", [
    (1, 37, 4, 4, 64, 64), (2, 128, 4, 4, 64, 32), (1, 200, 8, 2, 64, 64),
    (2, 1, 4, 1, 64, 64)])
def test_flash_hd80_matches_pallas_kernel(dtype, B, S, H, Hkv, bq, bk,
                                          counts):
    """Head dim 80 (zamba2's shared attention): K2's plain version against
    the reference's Pallas kernel in interpret mode (block specs ``(1, bq,
    80)``), equal heads and GQA through ``ops.flash_attention``."""
    q, k, v = _qkv(S * 80 + H + Hkv, B, S, H, Hkv, 80)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    if H == Hkv:
        want = ref_flash.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    else:
        want = ref_ops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = flash_attn.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), _t(want).float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_head_dims_of_k2_and_k10(counts):
    """K2 (and K11, which checks the same tuple) takes head dims 64, 80 and
    128 on the card; K10 keeps its own (32, 64, 80, 128): 32 is the
    launcher's ring demo, which K2 does not take.  On (fake) card tensors
    each refuses a width it lacks before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert flash_attn.HEAD_DIMS == (64, 80, 128)
    assert ishmem_device.PARTIAL_HEAD_DIMS == (32, 64, 80, 128)
    with FakeTensorMode():
        q96 = torch.zeros((1, 16, 2, 96), device="cuda")
        q48 = torch.zeros((1, 16, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        ishmem_device.flash_partial(q96, q96, q96, q_off=0, k_off=0)
    with pytest.raises(ValueError, match="head_dim 48"):
        ishmem_device.flash_partial_split(q48, q48, q48)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_attn.flash_attention(q96, q96, q96)


def test_flash_rejects_bad_input(counts):
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q, k.bfloat16(), v)


# ---------------------------------------------------------------------------
# K3: paged_gather vs ishmem_device.paged_gather
# ---------------------------------------------------------------------------


_GATHER_SHAPES = [(6, 128, 3, 4), (16, 384, 2, 8), (5, 37, 4, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("R,W,slots,nb,form", [
    pytest.param(*shape, form, id="-".join(map(str, shape)) + suffix)
    for form, suffix in (("tensor", ""), ("numpy", "-numpy"))
    for shape in _GATHER_SHAPES])
def test_paged_gather_matches_reference(dtype, R, W, slots, nb, form,
                                        counts):
    """Bitwise, with unmapped entries (index R) that read zeros; the
    reference appends the zero row itself, the port's kernel needs none.
    The table goes in as a CPU tensor or as the numpy array the serving
    path passes (a host table)."""
    rng = np.random.default_rng(R * 1000 + W)
    data = rng.normal(size=(R, W)).astype(np.float32) * 100
    table = rng.integers(0, R + 1, size=(slots, nb)).astype(np.int32)
    table[-1, -1] = R                                 # always one unmapped
    jd, td = _both(data, dtype)
    want = ref_dev.paged_gather(
        jnp.concatenate([jd, jnp.zeros((1, W), jd.dtype)]), table)
    got = ishmem_device.paged_gather(
        td, torch.from_numpy(table) if form == "tensor" else table)
    assert torch.equal(got, _t(want))


def test_paged_gather_rejects_bad_table(counts):
    data = torch.ones(4, 8)
    with pytest.raises(IndexError):
        ishmem_device.paged_gather(data, torch.tensor([[5]], dtype=torch.int32))
    with pytest.raises(IndexError):
        ishmem_device.paged_gather(data,
                                   torch.tensor([[-1]], dtype=torch.int32))
    with pytest.raises(TypeError):
        ishmem_device.paged_gather(data, torch.tensor([[1]]))   # int64


@pytest.mark.parametrize("entry", [-1, 5])
def test_paged_gather_rejects_host_table_outside_range(entry, counts):
    """A numpy table is range-checked on the host: -1 and R + 1 raise."""
    data = torch.ones(4, 8)
    table = np.array([[0, entry], [4, 1]], np.int32)
    with pytest.raises(IndexError):
        ishmem_device.paged_gather(data, table)
    with pytest.raises(TypeError):
        ishmem_device.paged_gather(data, table.astype(np.int64))


def test_paged_gather_card_table_with_cpu_data_raises(counts):
    """``data`` decides the route; a table on the card beside CPU data is
    refused before any of its values is read (a fake tensor stands in for
    the card's, which this machine may lack)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        table = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    assert table.device.type == "cuda"
    with pytest.raises(ValueError):
        ishmem_device.paged_gather(torch.ones(4, 8), table)


def test_assemble_host_table_matches_tensor_table(monkeypatch, counts):
    """``PagedDecodeView.assemble`` passes its numpy table as it is; the
    same table as a tensor gives the same leaves bitwise (a full slot, an
    unmapped slot that reads zeros, a partly mapped slot)."""
    from repro_torch.configs import base
    from repro_torch.core import context
    from repro_torch.core.heap import TORCH_DTYPES
    from repro_torch.serve.kvpool import KVPool
    from repro_torch.serve.paged_attn import PagedDecodeView
    cfg = base.reduced(base.get_config("qwen3-4b"))
    _, heap = context.init(npes=2, node_size=2, device="cpu")
    pool = KVPool.create(heap, cfg, 24, num_blocks=12, max_slots=3,
                         block_tokens=4)
    rng = np.random.default_rng(0)
    row = rng.normal(size=pool.data.size).astype(np.float32)
    heap = heap.write(pool.data, 1, torch.from_numpy(row).to(
        TORCH_DTYPES[pool.data.dtype]))
    view = PagedDecodeView(pool, 1, 3)
    nb = pool.layout.blocks_per_request
    for slot, rid, n in ((0, 7, nb), (2, 8, nb - 2)):
        assert pool.alloc(rid, n) is not None
        heap = view.attach(heap, slot, rid, fresh_ids=[])
    units = 1 + max(leaf.unit_idx for leaf in pool.layout.paged)
    cache = {"blocks": [{"k": torch.zeros(1), "v": torch.zeros(1)}
                        for _ in range(units)]}
    host = view.assemble(heap, cache)
    table = view.table()
    assert isinstance(table, np.ndarray)
    monkeypatch.setattr(view, "table", lambda: torch.from_numpy(table))
    as_tensor = view.assemble(heap, cache)
    for leaf in pool.layout.paged:
        got = host["blocks"][leaf.unit_idx][leaf.key]
        assert torch.equal(got, as_tensor["blocks"][leaf.unit_idx][leaf.key])
        assert not got[:, 1].any() and got[:, 0].any()


# ---------------------------------------------------------------------------
# dispatch and build
# ---------------------------------------------------------------------------


def test_non_cpu_tensors_never_take_the_plain_version(counts):
    """A wrapper takes the plain version only because its tensors lie on
    the CPU; tensors anywhere else go to the kernel or raise (here: the meta
    device, which no kernel takes)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        rma_copy.copy_into(torch.zeros(8, device=meta),
                           torch.zeros(2, device=meta), 0)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(*(torch.zeros(1, 4, 2, 8, device=meta),) * 3)
    with pytest.raises(ValueError):
        ops.on_cpu(torch.zeros(1), torch.zeros(1, device=meta))


def _on(device: str, *shape, dtype=torch.float32) -> torch.Tensor:
    """A tensor on ``device``; a CUDA one is a fake tensor (shape, dtype
    and device only), which this machine can make without a card."""
    if device.startswith("cuda"):
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            return torch.zeros(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("devices,want", [
    (("cpu",), True), (("cpu", "cpu"), True), (("cpu", "cpu", "cpu"), True),
    (("cuda",), False), (("cuda", "cuda", "cuda"), False),
    (("cuda:1", "cuda:1"), False),
    (("cpu", "meta"), ValueError), (("meta", "cpu"), ValueError),
    (("meta",), ValueError), (("cuda", "cpu"), ValueError),
    (("cpu", "cuda"), ValueError), (("cuda", "cuda:1"), ValueError),
    (("cuda", "meta"), ValueError),
], ids=lambda v: "-".join(v) if isinstance(v, tuple) else str(v))
def test_on_cpu_contract(devices, want):
    """True for all-CPU tensors, False for tensors on one CUDA device,
    ValueError for anything else."""
    tensors = [_on(d, 4) for d in devices]
    if want is ValueError:
        with pytest.raises(ValueError):
            ops.on_cpu(*tensors)
    else:
        assert ops.on_cpu(*tensors) is want


_F64 = torch.float64
COPY_BAD = {
    "offset past the end": (lambda: (_on("cpu", 256), _on("cpu", 10), 250),
                            IndexError),
    "negative offset": (lambda: (_on("cpu", 256), _on("cpu", 10), -1),
                        IndexError),
    "dtypes differ": (lambda: (_on("cpu", 256),
                               _on("cpu", 10, dtype=torch.int32), 0),
                      TypeError),
    "dtype not taken": (lambda: (_on("cpu", 8, dtype=_F64),
                                 _on("cpu", 2, dtype=_F64), 0), TypeError),
    "2-D row": (lambda: (_on("cpu", 4, 4), _on("cpu", 4), 0), ValueError),
    "strided row": (lambda: (_on("cpu", 512)[::2], _on("cpu", 4), 0),
                    ValueError),
    "strided src": (lambda: (_on("cpu", 256), _on("cpu", 20)[::2], 0),
                    ValueError),
    "2-D row of a bad dtype": (lambda: (_on("cpu", 4, 4, dtype=_F64),
                                        _on("cpu", 4, dtype=_F64), 0),
                               ValueError),
    "bad dtype past the end": (lambda: (_on("cpu", 256),
                                        _on("cpu", 10, dtype=torch.int32),
                                        250), TypeError),
    "cpu row, meta src": (lambda: (_on("cpu", 256), _on("meta", 10), 0),
                          ValueError),
    "cuda row, cpu src": (lambda: (_on("cuda", 256), _on("cpu", 10), 0),
                          ValueError),
    "cpu row, cuda src": (lambda: (_on("cpu", 256), _on("cuda", 10), 0),
                          ValueError),
    "row and src on two cards": (lambda: (_on("cuda", 256),
                                          _on("cuda:1", 10), 0), ValueError),
}


@pytest.mark.parametrize("case", COPY_BAD)
def test_copy_into_raises(case, counts):
    """Each bad input raises its exception before any launch, the first
    failing check deciding which (shape, contiguity, dtype, range, then
    devices)."""
    make, exc = COPY_BAD[case]
    row, src, offset = make()
    with pytest.raises(exc):
        rma_copy.copy_into(row, src, offset)


BROADCAST_BAD = {
    "dtype not taken": (lambda: (_on("cpu", 4, 8, dtype=_F64), 0), TypeError),
    "not contiguous": (lambda: (_on("cpu", 8, 4).t(), 0), ValueError),
    "root = npes": (lambda: (_on("cpu", 4, 8), 4), ValueError),
    "negative root": (lambda: (_on("cpu", 4, 8), -1), ValueError),
    "no PE axis": (lambda: (_on("cpu"), 0), ValueError),
    "no PEs": (lambda: (_on("cpu", 0, 8), 0), ValueError),
    "meta": (lambda: (_on("meta", 4, 8), 0), ValueError),
    "bad dtype and root": (lambda: (_on("cpu", 4, 8, dtype=_F64), 9),
                           TypeError),
    "cuda, root outside": (lambda: (_on("cuda", 4, 8), 4), ValueError),
}


@pytest.mark.parametrize("case", BROADCAST_BAD)
def test_push_broadcast_raises(case, counts):
    from repro_torch.kernels import ring_collectives
    make, exc = BROADCAST_BAD[case]
    x, root = make()
    with pytest.raises(exc):
        ring_collectives.push_broadcast(x, root)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc on PATH or under CUDA_HOME: the build says so, and nothing
    falls back."""
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_dir_is_keyed_by_sources():
    key = _build.build_dir()
    assert key.parent == _build.BUILD_ROOT and len(key.name) == 16
    assert _build.build_dir() == key


@pytest.mark.parametrize("name", ["tma.cuh", "flash_partial.cu"])
def test_build_dir_sees_every_csrc_file(name, monkeypatch, tmp_path):
    """An edit to a header changes the build's key as an edit to a source
    does, so no stale library is loaded."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    key = _build.build_dir()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert _build.build_dir() != key
