"""The port's SHMEM core against the JAX package's.

Two parts:

1. the heap laws of ``tests/test_heap.py`` proved again on the port's
   ``SymmetricHeap`` (CPU pools), plus the functional-update law the
   port's clone-on-write keeps: an old snapshot keeps its bytes;
2. one op script — put, get, p, put_nbi, fence, quiet, put_signal_nbi,
   signal_wait_until — replayed on both packages over PEs in three tiers.
   Data movement and control must agree exactly: every pool byte for byte,
   and the sequence of ``(op, nbytes, path, tier, work_items, t_sec)``
   telemetry records.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ref_context, cutover as ref_cutover, \
    rma as ref_rma, signal as ref_signal, teams as ref_teams
from repro_torch import _bridge
from repro_torch.core import context, cutover, heap as heap_mod, rma, \
    signal, teams
from _torch_threads import one_intra_op_thread  # noqa: F401


def _heap(npes=2, words=1 << 20):
    return heap_mod.create(npes, words, device="cpu")


# ---------------------------------------------------------------------------
# heap laws
# ---------------------------------------------------------------------------


def test_malloc_alignment_and_symmetry():
    h = _heap(4)
    a = h.malloc((100,), "float32")
    b = h.malloc((3, 5), "float32")
    assert a.offset % heap_mod.ALIGN == 0 and b.offset % heap_mod.ALIGN == 0
    assert b.offset >= a.offset + 128
    assert a.shape == (100,) and b.shape == (3, 5)
    h = h.write(a, 0, torch.ones(100))
    h = h.write(a, 3, torch.full((100,), 2.0))
    assert float(h.read(a, 0)[0]) == 1.0
    assert float(h.read(a, 3)[0]) == 2.0
    assert float(h.read(a, 1)[0]) == 0.0


def test_free_reuse_first_fit():
    h = _heap()
    a = h.malloc((256,), "float32")
    h.free(a)
    assert h.malloc((128,), "float32").offset == a.offset


def test_calloc_zeroes_reused_region():
    h = _heap()
    a = h.malloc((256,), "float32")
    h = h.write(a, 1, torch.full((256,), 7.0))
    h.free(a)
    b = h.calloc((256,), "float32")
    assert b.offset == a.offset
    assert torch.equal(h.read(b, 1), torch.zeros(256))
    assert torch.equal(h.read(b, 0), torch.zeros(256))


def test_malloc_reuse_is_dirty_but_calloc_is_not():
    h = _heap(1)
    a = h.malloc((128,), "float32")
    h = h.write(a, 0, torch.ones(128))
    h.free(a)
    c = h.malloc((128,), "float32")
    assert float(h.read(c, 0)[0]) == 1.0


def test_free_coalesces_adjacent_extents():
    h = _heap(1)
    ptrs = [h.malloc((128,), "float32") for _ in range(4)]
    keep = h.malloc((128,), "float32")
    for p in (ptrs[0], ptrs[2], ptrs[1], ptrs[3]):
        h.free(p)
    assert h._free["float32"] == [(ptrs[0].offset, 4 * 128)]
    assert h.malloc((512,), "float32").offset == ptrs[0].offset
    assert keep.offset >= 4 * 128


def test_heap_stats_accounting():
    h = _heap()
    a = h.malloc((256,), "float32")
    h.malloc((128,), "int32")
    s = h.stats()
    assert s["bytes_in_use"] == 256 * 4 + 128 * 4 and s["bytes_free"] == 0
    h.free(a)
    s = h.stats()["pools"]
    assert s["float32"]["bytes_free"] == 256 * 4
    assert s["float32"]["bytes_in_use"] == 0
    assert s["int32"]["bytes_in_use"] == 128 * 4
    h2 = _heap(1)
    x, _, z = (h2.malloc((128,), "float32") for _ in range(3))
    h2.free(x)
    h2.free(z)
    st = h2.stats()["pools"]["float32"]
    assert st["free_extents"] == 2 and st["fragmentation"] == 0.5


def test_pool_growth_by_doubling():
    h = _heap(2, words=256)
    ptrs = [h.malloc((128,), "float32") for _ in range(8)]
    assert h.pools["float32"].shape == (2, 1024)
    h = h.write(ptrs[-1], 1, torch.arange(128))
    assert float(h.read(ptrs[-1], 1)[5]) == 5.0


@pytest.mark.parametrize("dtype,want", [
    ("int64", "int32"), ("float64", "float32"), (np.int64, "int32"),
    (torch.int64, "int32"), (torch.bfloat16, "bfloat16"),
    ("bfloat16", "bfloat16"), ("int32", "int32")])
def test_dtype_canonicalization(dtype, want):
    h = _heap()
    assert h.malloc((), dtype).dtype == want


def test_read_all_write_all():
    h = _heap(3)
    p = h.malloc((4,), "int32")
    h = h.write_all(p, torch.arange(12).reshape(3, 4))
    assert torch.equal(h.read_all(p), torch.arange(12, dtype=torch.int32)
                       .reshape(3, 4))


def test_ptr_index_bounds():
    p = _heap().malloc((8,), "float32")
    assert p.index(7).offset == p.offset + 7
    with pytest.raises(IndexError):
        p.index(8)


@pytest.mark.parametrize("seed", range(6))
def test_allocations_never_overlap(seed):
    rng = np.random.default_rng(seed)
    h = _heap(1)
    spans = {"float32": [], "int32": []}
    for _ in range(int(rng.integers(1, 21))):
        n = int(rng.integers(1, 501))
        dt = ["float32", "int32"][int(rng.integers(0, 2))]
        p = h.malloc((n,), dt)
        lo, hi = p.offset, p.offset + max(128, -(-n // 128) * 128)
        assert all(hi <= l2 or lo >= h2 for l2, h2 in spans[dt])
        spans[dt].append((lo, hi))


def test_old_snapshots_keep_their_bytes():
    """write() is functional: the heap it was called on keeps its bytes,
    and calloc on a later heap never disturbs an earlier snapshot."""
    h0 = _heap()
    a = h0.malloc((200,), "float32")
    h1 = h0.write(a, 1, torch.full((200,), 3.0))
    h2 = h1.write(a, 1, torch.full((200,), 4.0))
    assert float(h0.read(a, 1)[0]) == 0.0
    assert float(h1.read(a, 1)[0]) == 3.0
    assert float(h2.read(a, 1)[0]) == 4.0
    h2.free(a)
    h2.calloc((200,), "float32")
    assert float(h1.read(a, 1)[0]) == 3.0


# ---------------------------------------------------------------------------
# op-script replay on both packages
# ---------------------------------------------------------------------------


NPES, NODE = 4, 2            # PEs 0-1 and 2-3 are pods: local, ici and dcn


class _Side:
    """One package's context, heap and allocations, driven by the script."""

    def __init__(self, ref: bool):
        self.ref = ref
        if ref:
            self.ctx, self.heap = ref_context.init(npes=NPES, node_size=NODE)
            self.rma, self.sig = ref_rma, ref_signal
        else:
            self.ctx, self.heap = context.init(npes=NPES, node_size=NODE,
                                               device="cpu")
            self.rma, self.sig = rma, signal
        self.f = self.heap.malloc((3000,), "float32")
        self.b = self.heap.malloc((1024,), "bfloat16")
        self.s = self.heap.malloc((4,), "int32")
        self.got = []

    def ptr(self, name, off=0, n=None):
        base = getattr(self, name)
        n = base.size - off if n is None else n
        return type(base)(base.dtype, base.offset + off, (n,))

    def val(self, x, dtype):
        return jnp.asarray(x).astype(dtype) if self.ref else \
            torch.from_numpy(x).to(getattr(torch, dtype))

    def pools(self):
        return {dt: _bridge.array_to_torch(np.asarray(p), "cpu")
                if self.ref else p for dt, p in self.heap.pools.items()}

    def records(self):
        return [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
                for r in self.ctx.telemetry.trace]


def _script(side: _Side, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    f = lambda n: rng.normal(size=n).astype(np.float32)
    R, S = side.rma, side.sig
    h = side.heap
    ctx = side.ctx
    # blocking puts at every tier, small and large (direct vs engine)
    h = R.put(ctx, h, side.ptr("f", 0, 100), side.val(f(100), "float32"), 1,
              src_pe=1)
    h = R.put(ctx, h, side.ptr("f", 128, 2800), side.val(f(2800), "float32"),
              3, src_pe=2)
    h = R.put(ctx, h, side.ptr("f", 128, 2800), side.val(f(2800), "float32"),
              3, src_pe=2, work_items=64)
    h = R.put(ctx, h, side.ptr("b", 0, 1024), side.val(f(1024), "bfloat16"),
              2, src_pe=0, work_items=8)
    h = R.p(ctx, h, side.ptr("s", 1, 1), 7, 3, src_pe=0)
    side.got.append(R.get(ctx, h, side.ptr("f", 0, 100), 1, src_pe=3))
    # queue-adjacent contiguous nbi puts coalesce; a fence splits epochs
    for i in range(3):
        h = R.put_nbi(ctx, h, side.ptr("f", 200 + 100 * i, 100),
                      side.val(f(100), "float32"), 2, src_pe=0, work_items=4)
    h = R.fence(ctx, h)
    h = R.put_nbi(ctx, h, side.ptr("f", 500, 100),
                  side.val(f(100), "float32"), 2, src_pe=0)
    side.got.append(R.get(ctx, h, side.ptr("f", 200, 300), 2, src_pe=2))
    h = R.quiet(ctx, h)
    # a blocking put supersedes the pending nbi put it covers
    h = R.put_nbi(ctx, h, side.ptr("f", 1000, 64),
                  side.val(f(64), "float32"), 1, src_pe=0)
    h = R.put(ctx, h, side.ptr("f", 1000, 128), side.val(f(128), "float32"),
              1, src_pe=0)
    # put_signal_nbi pairs; the wait forces exactly its dependency prefix
    for i in range(2):
        h = S.put_signal_nbi(ctx, h, side.ptr("b", 256 * i, 256),
                             side.val(f(256), "bfloat16"), side.ptr("s", 0, 1),
                             1, S.SIGNAL_ADD, 3, src_pe=1, work_items=16)
    h = S.put_signal_nbi(ctx, h, side.ptr("f", 2000, 50),
                         side.val(f(50), "float32"), side.ptr("s", 2, 1), 5,
                         S.SIGNAL_SET, 0, src_pe=3)
    h, cur, ok = S.signal_wait_until(ctx, h, side.ptr("s", 0, 1), 3, "ge", 2)
    side.got.append((int(cur), bool(ok), len(ctx.pending)))
    h, cur, ok = S.signal_wait_until(ctx, h, side.ptr("s", 2, 1), 0, "eq", 9)
    side.got.append((int(cur), bool(ok), len(ctx.pending)))
    h = R.quiet(ctx, h)
    side.heap = h


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("coalesce", [True, False])
def test_op_script_matches_reference(seed, coalesce):
    sides = [_Side(ref=True), _Side(ref=False)]
    for side in sides:
        side.ctx.tuning = type(side.ctx.tuning)(nbi_coalesce=coalesce)
        _script(side, seed)
    ref, port = sides
    ref_pools, port_pools = ref.pools(), port.pools()
    assert ref_pools.keys() == port_pools.keys()
    for dt in ref_pools:
        assert torch.equal(ref_pools[dt], port_pools[dt]), dt
    assert ref.records() == port.records()
    for a, b in zip(ref.got, port.got):
        if isinstance(a, tuple):
            assert a == b
        else:
            assert torch.equal(_bridge.array_to_torch(np.asarray(a), "cpu"),
                               b)
    rs, ps = ref.ctx.pending.stats, port.ctx.pending.stats
    assert (rs.submitted, rs.flushed_ops, rs.transfers, rs.flushed_bytes,
            rs.transfer_bytes, rs.flushes) == (
        ps.submitted, ps.flushed_ops, ps.transfers, ps.flushed_bytes,
        ps.transfer_bytes, ps.flushes)
    if coalesce:
        assert ps.coalescing_ratio() > 1.0


def test_pending_ops_leave_target_untouched_until_quiet():
    ctx, h = context.init(npes=2, device="cpu")
    p = h.malloc((128,), "float32")
    h = rma.put_nbi(ctx, h, p, torch.ones(128), 1)
    assert torch.equal(h.read(p, 1), torch.zeros(128)) and len(ctx.pending)
    h = rma.quiet(ctx, h)
    assert torch.equal(h.read(p, 1), torch.ones(128)) and not ctx.pending


# ---------------------------------------------------------------------------
# the plain-Python copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["local", "ici", "dcn"])
@pytest.mark.parametrize("work_items", [1, 8, 128])
def test_cutover_choices_match_reference(tier, work_items):
    for nbytes in (4, 512, 4096, 65536, 1 << 20, 1 << 24):
        assert cutover.choose_path(nbytes, work_items=work_items, tier=tier) \
            == ref_cutover.choose_path(nbytes, work_items=work_items,
                                       tier=tier)
        for path in ("direct", "engine", "proxy"):
            assert cutover.op_time(nbytes, path, work_items=work_items,
                                   tier=tier) == ref_cutover.op_time(
                nbytes, path, work_items=work_items, tier=tier)


def test_teams_match_reference():
    for mod in (teams, ref_teams):
        w = mod.world(8)
        pre, dec = mod.disagg_partition(w, 3)
        assert (pre.pes(), dec.pes()) == ([0, 1, 2], [3, 4, 5, 6, 7])
        assert w.split_strided(1, 2, 3).rank_of(5) == 2
        assert w.split_strided(1, 2, 3).translate(2) == 5
        with pytest.raises(ValueError):
            w.split_strided(4, 2, 3)
        with pytest.raises(ValueError):
            mod.disagg_partition(w, 8)
