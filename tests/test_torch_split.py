"""K10's split-precision design, held on the CPU.

The card's K10 (``csrc/flash_partial.cu``) writes every operand as TF32
hi + lo parts (the split pass) and takes three TF32 products per matrix
product on the tensor cores.  Here the split pass's plain version is held
to its definition, and a numpy-seeded emulation of the kernel's arithmetic
(its tiles, its online softmax, the three products over the split planes,
V^T's key order) is held to the reference's unchanged 2e-5 checks: against
the Pallas ``flash_partial`` in interpret mode (as
``tests/test_torch_device.py::test_flash_partial_plain_matches_pallas``
runs it) and against ``flash_partial_plain``, at unit and 0.1 input scale
and at shapes with rows that see no key.  The kernel itself runs only on a
card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attn, ishmem_device, ops
from _torch_threads import one_intra_op_thread  # noqa: F401

TOL = 2e-5                 # tests/test_kernels.py, f32
LOG2E = 1.4426950408889634
BQ, BK = 64, 32            # the kernel's q and key tiles
COLS = 32                  # f32 columns of one 128-byte TMA box


@pytest.fixture
def counts():
    ops.reset_launches()
    yield ops.LAUNCHES
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}, \
        "a CPU tensor launched a kernel"


def _inputs(seed, Sq, Skv, H, hd, scale, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(1, S, H, hd)).astype(np.float32) * scale
               for S in (Sq, Skv, Skv))
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v))


# ---------------------------------------------------------------------------
# the split pass's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 0.1, 1e-3, 300.0])
def test_split_parts_are_tf32_and_reconstruct(scale, counts):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi = ishmem_device.tf32_round(x)
    lo = ishmem_device.tf32_round(x - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi is the nearest TF32 value: within half a TF32 step of x
    assert bool(((x - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -22).all())


def test_tf32_round_ties_away_from_zero(counts):
    one = 2.0 ** -10                     # a TF32 step at 1
    x = torch.tensor([1 + one / 2, -(1 + one / 2), 1 + 1.5 * one,
                      1 + one / 2 - 2.0 ** -23, 0.0, -0.0])
    want = torch.tensor([1 + one, -(1 + one), 1 + 2 * one, 1.0, 0.0, -0.0])
    got = ishmem_device.tf32_round(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("Skv", [1, 8, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_layout(Skv, dtype, counts):
    """q * hd**-0.5 and k as (2, B, S, H, hd) hi/lo planes; v transposed to
    (2, B, H, hd, Skv8) with each group of 8 keys in KEY_ORDER and zeros
    past Skv, by an index computation; bf16 k and v have no low part."""
    B, Sq, H, hd = 2, 5, 3, 32
    q, k, v = _inputs(Skv, Sq, Skv, H, hd, 1.0, dtype)
    q, k, v = (torch.cat([t, t * 0.5]) for t in (q, k, v))  # B = 2
    qs, ks, vt = ishmem_device.flash_partial_split_plain(q, k, v)
    Skv8 = -(-Skv // 8) * 8
    assert qs.shape == (2, B, Sq, H, hd) and ks.shape == (2, B, Skv, H, hd)
    assert vt.shape == (2, B, H, hd, Skv8)
    for planes, x in ((qs, q.float() * hd ** -0.5), (ks, k.float())):
        hi = ishmem_device.tf32_round(x)
        assert torch.equal(planes[0], hi)
        assert torch.equal(planes[1], ishmem_device.tf32_round(x - hi))
    order = ishmem_device.KEY_ORDER
    assert sorted(order) == list(range(8))
    vf = v.float()
    for pos in range(Skv8):
        key = 8 * (pos // 8) + order[pos % 8]
        want = vf[:, key] if key < Skv else torch.zeros(B, H, hd)
        hi = ishmem_device.tf32_round(want)
        assert torch.equal(vt[0, :, :, :, pos], hi)
        assert torch.equal(vt[1, :, :, :, pos],
                           ishmem_device.tf32_round(want - hi))
    if dtype == torch.bfloat16:
        assert not ks[1].any() and not vt[1].any()


def test_split_wrapper_takes_the_plain_version_on_cpu(counts):
    q, k, v = _inputs(3, 9, 13, 2, 64, 1.0)
    got = ishmem_device.flash_partial_split(q, k, v)
    want = ishmem_device.flash_partial_split_plain(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        ishmem_device.flash_partial_split(q, k[:, :, :1], v)
    meta = [t.to("meta") for t in (q, k, v)]  # the dry-run: empty planes
    assert [(t.shape, t.dtype, t.is_meta) for t in
            ishmem_device.flash_partial_split(*meta)] == \
        [(t.shape, t.dtype, True) for t in want]
    with pytest.raises(ValueError):
        ishmem_device.flash_partial_split(q, *meta[1:])


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _qk(qt, kt, n_steps):
    """Q.K^T as the kernel's k8 steps over the first ``8 * n_steps``
    columns of the tiles, accumulated in f32 in step order."""
    s = 0
    for kk in range(n_steps):
        c = slice(8 * kk, 8 * kk + 8)
        s = s + qt[..., c] @ kt[..., c].transpose(-1, -2)
    return s


def emulate_kernel(q, k, v, *, q_off, k_off, steps="real"):
    """K10's arithmetic on the split pass's planes, tile by tile as the
    kernel runs it: per q tile of 64 rows the causal key limit, per key tile
    of 32 S = Qhi.Khi + Qlo.Khi + Qhi.Klo, the mask, m, corr = 2^((m -
    m_new) log2 e), p = 2^((s - m_new) log2 e), then O = O corr + Phi.Vhi +
    Plo.Vhi + Phi.Vlo with P's columns and V^T's keys in V^T's order.  All
    f32 (the tensor cores' products of TF32 parts are exact in f32)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qs, ks, vt = ishmem_device.flash_partial_split_plain(q, k, v)
    Skv8 = vt.shape[-1]
    # q and K tiles are whole 32-column boxes, zero-filled past hd (hd 80
    # pads to 96); Q.K^T runs k8 steps over the real columns, or over the
    # whole tile with ``steps="padded"``
    pad = -(-hd // COLS) * COLS
    qs, ks = (torch.nn.functional.pad(x, (0, pad - hd)) for x in (qs, ks))
    n_steps = (pad if steps == "padded" else hd) // 8
    order = torch.tensor(ishmem_device.KEY_ORDER)
    pos_key = (torch.arange(0, Skv8, 8)[:, None] + order).reshape(-1)
    acc = torch.zeros(B, H, Sq, hd)
    m = torch.zeros(B, H, Sq)
    l = torch.zeros(B, H, Sq)
    qh, ql = (x.permute(0, 2, 1, 3) for x in qs)           # (B, H, Sq, hd)
    kh, kl = (x.permute(0, 2, 1, 3) for x in ks)           # (B, H, Skv, hd)
    for q0 in range(0, Sq, BQ):
        rows = slice(q0, min(Sq, q0 + BQ))
        kv_end = Skv
        if q_off + q0 >= k_off:
            kv_end = min(Skv, q_off + rows.stop - k_off)
        qpos = q_off + torch.arange(rows.start, rows.stop)
        mi = torch.full((B, H, rows.stop - q0), flash_attn.NEG_INF)
        li = torch.zeros_like(mi)
        oi = torch.zeros(B, H, rows.stop - q0, hd)
        for k0 in range(0, kv_end, BK):
            keys = slice(k0, min(Skv, k0 + BK))
            s = (_qk(qh[:, :, rows], kh[:, :, keys], n_steps)
                 + _qk(ql[:, :, rows], kh[:, :, keys], n_steps)
                 + _qk(qh[:, :, rows], kl[:, :, keys], n_steps))
            kpos = k_off + torch.arange(keys.start, keys.stop)
            s = torch.where(kpos[None, :] <= qpos[:, None], s,
                            torch.tensor(flash_attn.NEG_INF))
            m_new = torch.maximum(mi, s.amax(-1))
            corr = torch.exp2((mi - m_new) * LOG2E)
            p = torch.exp2((s - m_new[..., None]) * LOG2E)
            li = li * corr + p.sum(-1)
            # P over V^T's positions of this tile: keys past Skv weigh 0
            pos = torch.arange(k0, min(Skv8, k0 + BK))
            key = pos_key[pos]
            pp = torch.zeros(*p.shape[:-1], len(pos))
            have = key < Skv
            pp[..., have] = p[..., key[have] - k0]
            ph = ishmem_device.tf32_round(pp)
            pl = ishmem_device.tf32_round(pp - ph)
            vh, vl = (x[..., pos].transpose(-1, -2) for x in vt)
            oi = oi * corr[..., None] + ph @ vh + pl @ vh + ph @ vl
            mi = m_new
        acc[:, :, rows], m[:, :, rows], l[:, :, rows] = oi, mi, li
    return (acc.permute(0, 2, 1, 3).contiguous(),
            m.permute(0, 2, 1).contiguous(), l.permute(0, 2, 1).contiguous())


def _hold(got, want, seen):
    """``chip_smoke.py``'s K10 checks: raw acc within TOL * (l + |acc|)
    per row, acc/l, m and l within TOL absolute and relative, on the rows
    that see a key; on the others m = -1e30 and l = Skv exactly, acc = sum
    v within TOL; the merged outputs within TOL."""
    (a, m, l), (pa, pm, pl) = got, want
    s = seen
    assert bool(((a - pa).abs()[:, s] <= (TOL * pl[..., None] + TOL *
                                          pa.abs())[:, s]).all())
    for x, y in ((a / l[..., None], pa / pl[..., None]), (m, pm), (l, pl)):
        torch.testing.assert_close(x[:, s], y[:, s], atol=TOL, rtol=TOL)
    blind = ~s
    assert bool((m[:, blind] == flash_attn.NEG_INF).all())
    assert torch.equal(l[:, blind], pl[:, blind])
    torch.testing.assert_close(a[:, blind], pa[:, blind], atol=TOL, rtol=TOL)
    torch.testing.assert_close(ishmem_device.merge_partials([got]),
                               ishmem_device.merge_partials([want]),
                               atol=TOL, rtol=TOL)


SHAPES = [
    (64, 64, 0, 0, 2, 64),           # diagonal shard
    (128, 96, 128, 0, 2, 64),        # a past shard: every key visible
    (64, 32, 0, 32, 2, 128),         # half the rows see no key
    (32, 32, 0, 32, 1, 64),          # a future shard: every row blind
    (100, 37, 50, 10, 2, 64),        # ragged tiles
    (37, 100, 0, 20, 1, 128),        # some rows see no key, ragged
]


SHAPES_PADDED = [
    (64, 64, 0, 0, 2, 32),           # hd 32: one box a row
    (64, 32, 0, 32, 2, 32),          # half the rows see no key
    (100, 37, 50, 10, 2, 80),        # hd 80: three boxes, 16 zero columns
    (37, 100, 0, 20, 1, 80),
]


@pytest.mark.parametrize("scale", [1.0, 0.1])
@pytest.mark.parametrize("Sq,Skv,q_off,k_off,H,hd", SHAPES + SHAPES_PADDED)
def test_emulated_3xtf32_within_tolerance(Sq, Skv, q_off, k_off, H, hd,
                                          scale, counts):
    q, k, v = _inputs(Sq * 7 + Skv + k_off, Sq, Skv, H, hd, scale)
    got = emulate_kernel(q, k, v, q_off=q_off, k_off=k_off)
    seen = (q_off + torch.arange(Sq)) >= k_off
    _hold(got, ishmem_device.flash_partial_plain(q, k, v, q_off=q_off,
                                                 k_off=k_off), seen)
    want = ref_ops.flash_partial(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                 q_off=q_off, k_off=k_off)
    _hold(got, tuple(torch.from_numpy(np.asarray(x)) for x in want), seen)


def test_emulated_bf16_inputs_within_tolerance(counts):
    """bf16 inputs: k and v have no low part, so the kernel's skipped
    products add exactly 0."""
    q, k, v = _inputs(11, 96, 80, 2, 64, 1.0, torch.bfloat16)
    got = emulate_kernel(q, k, v, q_off=80, k_off=0)
    seen = torch.ones(96, dtype=torch.bool)
    _hold(got, ishmem_device.flash_partial_plain(q, k, v, q_off=80, k_off=0),
          seen)


def test_single_tf32_products_miss_the_tolerance(counts):
    """Why three products: one TF32 product per term (hi.hi) misses the
    2e-5 checks at unit scale, the same inputs that the split meets."""
    q, k, v = _inputs(5, 64, 64, 2, 128, 1.0)
    tq, tk, tv = (ishmem_device.tf32_round(x) for x in (q * 128 ** -0.5, k, v))
    one = ishmem_device.flash_partial_plain(tq / 128 ** -0.5, tk, tv, q_off=0,
                                            k_off=0)
    want = ishmem_device.flash_partial_plain(q, k, v, q_off=0, k_off=0)
    with pytest.raises(AssertionError):
        _hold(one, want, torch.ones(64, dtype=torch.bool))


@pytest.mark.parametrize("hd", [32, 80])
def test_padded_tile_columns_add_exactly_zero(hd, counts):
    """The zero fill past hd in the q and K tiles: running Q.K^T over the
    whole padded tile gives the bits of the real columns' k8 steps, so the
    kernel may stop at hd / 8 steps (10 at hd 80)."""
    q, k, v = _inputs(hd, 70, 45, 2, hd, 1.0)
    real = emulate_kernel(q, k, v, q_off=0, k_off=0)
    padded = emulate_kernel(q, k, v, q_off=0, k_off=0, steps="padded")
    for a, b in zip(real, padded):
        assert torch.equal(a, b)


def _kperm(i):
    return 2 * i if i < 4 else 2 * i - 7


def emulate_split_vt(v):
    """``split_vt`` CTA by CTA: one block per 32 keys x 32 head dims of a
    (batch, head), ``ceil(hd / 32)`` blocks of dims (the last partial at hd
    80), loads of dims past hd as zeros and no writes past hd.  Cells no
    block writes stay NaN."""
    B, Skv, H, hd = v.shape
    Skv8 = -(-Skv // 8) * 8
    vf = v.float()
    vt = torch.full((2, B, H, hd, Skv8), float("nan"))
    src = torch.tensor([(tx & ~7) | _kperm(tx & 7) for tx in range(32)])
    for b in range(B):
        for h in range(H):
            for k0 in range(0, Skv8, 32):
                for d0 in range(0, -(-hd // 32) * 32, 32):
                    tile = torch.zeros(32, 32)
                    keys = min(Skv, k0 + 32) - k0
                    dims = min(hd, d0 + 32) - d0
                    tile[:keys, :dims] = vf[b, k0:k0 + keys, h, d0:d0 + dims]
                    n_pos = min(Skv8, k0 + 32) - k0
                    y = tile[src[:n_pos]].T[:dims]        # (dims, n_pos)
                    hi = ishmem_device.tf32_round(y)
                    vt[0, b, h, d0:d0 + dims, k0:k0 + n_pos] = hi
                    vt[1, b, h, d0:d0 + dims, k0:k0 + n_pos] = \
                        ishmem_device.tf32_round(y - hi)
    return vt


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("Skv", [5, 37, 64])
def test_split_vt_blocks_write_the_plain_layout(hd, Skv, counts):
    """The split pass's V^T at every head dim K10 takes: the CTA tiling
    (partial last block of dims at hd 80) writes every cell, bitwise the
    plain version's."""
    _, _, v = _inputs(hd + Skv, 1, Skv, 2, hd, 1.0)
    v = torch.cat([v, v * 3])                              # B = 2
    got = emulate_split_vt(v)
    want = ishmem_device.flash_partial_split_plain(v, v, v)[2]
    assert not bool(torch.isnan(got).any())
    assert torch.equal(got, want)
