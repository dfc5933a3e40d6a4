"""The port's host-path SHMEM layer — AMOs, team collectives, teams, the
GET/AMO queue entries, the strided and blocking-signal RMA ops and the
``Ishmem`` facade — held against the JAX package.

Each script runs on both packages (CPU heaps) from the same numpy inputs,
mirroring ``tests/test_amo.py``, ``test_collectives_core.py``,
``test_teams.py`` and ``test_ishmem_api.py``.  Everything is data movement,
control or a fixed sequence of elementwise ops, so it must agree exactly:
every pool byte for byte, every returned old value and satisfied array, and
the sequence of ``(op, nbytes, path, tier, work_items, t_sec)`` telemetry
records.  The port keeps no unsigned pool, so the bitwise AMOs run on int32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # clean interpreter: deterministic fallback
    from _minihyp import given, settings, strategies as st

from repro.core import amo as ref_amo, collectives as ref_coll, \
    context as ref_context, rma as ref_rma, signal as ref_signal, \
    teams as ref_teams
from repro.core.api import Ishmem as RefIshmem
from repro_torch import _bridge
from repro_torch.core import amo, collectives as coll, context, rma, signal, \
    teams
from repro_torch.core.api import Ishmem
from repro_torch.kernels import ops
from _torch_threads import one_intra_op_thread  # noqa: F401


class _Side:
    """One package's modules, context and heap, driven by a script."""

    def __init__(self, ref: bool, npes=8, node_size=4, facade=False):
        self.ref = ref
        if ref:
            self.amo, self.coll, self.rma, self.sig = (ref_amo, ref_coll,
                                                       ref_rma, ref_signal)
            self.teams = ref_teams
            if facade:
                self.sh = RefIshmem(npes=npes, node_size=node_size)
            else:
                self.ctx, self.heap = ref_context.init(npes=npes,
                                                       node_size=node_size)
        else:
            self.amo, self.coll, self.rma, self.sig = amo, coll, rma, signal
            self.teams = teams
            if facade:
                self.sh = Ishmem(npes=npes, node_size=node_size, device="cpu")
            else:
                self.ctx, self.heap = context.init(npes=npes,
                                                   node_size=node_size,
                                                   device="cpu")
        if facade:
            self.ctx = self.sh.ctx
        self.got = []

    @property
    def h(self):
        return self.sh.heap if hasattr(self, "sh") else self.heap

    def arr(self, x, dtype="float32"):
        x = np.asarray(x)
        return jnp.asarray(x).astype(dtype) if self.ref else \
            torch.from_numpy(x).to(getattr(torch, dtype))

    def keep(self, v):
        """Record a returned value (array, bool array or scalar)."""
        if isinstance(v, (bool, int, float, tuple)):
            self.got.append(v)
        elif self.ref:
            self.got.append(_bridge.array_to_torch(np.asarray(v), "cpu"))
        else:
            self.got.append(v.detach().cpu().clone())

    def pools(self):
        return {dt: _bridge.array_to_torch(np.asarray(p), "cpu")
                if self.ref else p for dt, p in self.h.pools.items()}

    def records(self):
        return [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
                for r in self.ctx.telemetry.trace]


def _same(script, **kw):
    """Run ``script(side)`` on both packages and require exact agreement."""
    sides = [_Side(ref=True, **kw), _Side(ref=False, **kw)]
    ops.reset_launches()
    for side in sides:
        script(side)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}
    ref, port = sides
    rp, pp = ref.pools(), port.pools()
    assert rp.keys() == pp.keys()
    for dt in rp:
        assert torch.equal(rp[dt], pp[dt]), dt
    assert ref.records() == port.records()
    assert len(ref.got) == len(port.got)
    for a, b in zip(ref.got, port.got):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.reshape(a.shape))
        else:
            assert a == b
    return port


# ---------------------------------------------------------------------------
# AMOs (test_amo.py)
# ---------------------------------------------------------------------------


def test_fetch_add_inc():
    def script(s):
        p = s.heap.malloc((), "int32")
        s.heap, old = s.amo.fetch_add(s.ctx, s.heap, p, 5, 2)
        s.keep(old)
        s.heap, old = s.amo.fetch_inc(s.ctx, s.heap, p, 2)
        s.keep(old)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 2))
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 1))
    port = _same(script, npes=4, node_size=4)
    assert [int(v) for v in port.got] == [0, 5, 6, 0]


def test_swap_cswap_set():
    def script(s):
        p = s.heap.malloc((), "int32")
        s.heap = s.amo.set_(s.ctx, s.heap, p, 7, 0)
        s.heap, old = s.amo.swap(s.ctx, s.heap, p, 9, 0)
        s.keep(old)
        s.heap, old = s.amo.compare_swap(s.ctx, s.heap, p, 9, 11, 0)
        s.keep(old)
        s.heap, old = s.amo.compare_swap(s.ctx, s.heap, p, 999, 0, 0)
        s.keep(old)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 0))
        s.heap = s.amo.inc(s.ctx, s.heap, p, 3, src_pe=0)
        s.heap = s.amo.add(s.ctx, s.heap, p, -4, 3, src_pe=1)
    port = _same(script, npes=4, node_size=2)
    assert [int(v) for v in port.got] == [7, 9, 11, 11]


def test_bitwise():
    def script(s):
        p = s.heap.malloc((), "int32")
        s.heap = s.amo.set_(s.ctx, s.heap, p, 0b1100, 1)
        for fn, v in (("fetch_and", 0b1010), ("fetch_or", 0b0001),
                      ("fetch_xor", 0b1111)):
            s.heap, old = getattr(s.amo, fn)(s.ctx, s.heap, p, v, 1)
            s.keep(old)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 1))
    port = _same(script, npes=4, node_size=4)
    assert [int(v) for v in port.got] == [0b1100, 0b1000, 0b1001, 0b0110]


def test_float_amo():
    def script(s):
        p = s.heap.malloc((), "float32")
        s.heap, _ = s.amo.fetch_add(s.ctx, s.heap, p, 0.5, 3)
        s.heap, _ = s.amo.fetch_add(s.ctx, s.heap, p, 0.25, 3)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 3))
    port = _same(script, npes=4, node_size=4)
    assert float(port.got[0]) == 0.75


def test_nbi_amos_merge_and_gets_defer():
    """Queue-adjacent adds to one element merge into one atomic; a fence
    splits them; get_nbi's cost lands at quiet; AMOs across tiers."""
    def script(s):
        p = s.heap.malloc((), "int32")
        q = s.heap.malloc((4,), "float32")
        s.heap = s.rma.put(s.ctx, s.heap, q, s.arr([1, 2, 3, 4]), 5, src_pe=0)
        for v in (1, 2, 3):
            s.heap = s.amo.add_nbi(s.ctx, s.heap, p, v, 6, src_pe=0)
        s.heap = s.rma.fence(s.ctx, s.heap)
        s.heap = s.amo.inc_nbi(s.ctx, s.heap, p, 6)
        s.heap = s.amo.set_nbi(s.ctx, s.heap, p, 40, 1)
        s.keep(s.rma.get_nbi(s.ctx, s.heap, q, 5, src_pe=1))
        s.keep(len(s.ctx.pending))
        cq = s.ctx.pending
        s.keep((cq.pending_first(p, 6), cq.pending_for(p, 6),
                cq.pending_first(p, 1), cq.pending_first(q, 5),
                cq.pending_first(p, 0)))
        # forces the adds first; the heap they land in is threaded on (the
        # reference's ``fetch`` returns the pre-image alone, and its heap
        # then keeps no flushed add, where the port's stores in place)
        s.heap, old = s.amo._rmw(s.ctx, s.heap, p, 6, lambda o: o, "fetch")
        s.keep(old)
        s.keep(len(s.ctx.pending))
        s.heap = s.rma.quiet(s.ctx, s.heap)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 1))
        st = s.ctx.pending.stats
        s.keep((st.submitted, st.flushed_ops, st.transfers, st.flushes))
    port = _same(script, npes=8, node_size=4)
    assert port.got[2] == (0, 3, 4, 5, None)
    assert int(port.got[3]) == 7 and int(port.got[5]) == 40
    assert port.got[6] == (6, 6, 4, 2)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["add", "cswap", "swap"]),
                          st.integers(-5, 5)), max_size=15))
def test_linearizable_like_the_reference(amo_ops):
    """Any sequential schedule of AMOs returns the reference's pre-images
    and leaves its heap bytes, which match a plain Python model."""
    def script(s):
        p = s.heap.malloc((), "int32")
        model = 0
        for kind, v in amo_ops:
            if kind == "add":
                s.heap, old = s.amo.fetch_add(s.ctx, s.heap, p, v, 0)
                model += v
            elif kind == "swap":
                s.heap, old = s.amo.swap(s.ctx, s.heap, p, v, 0)
                model = v
            else:
                s.heap, old = s.amo.compare_swap(s.ctx, s.heap, p, model, v,
                                                 0)
                model = v
            s.keep(old)
        s.keep(s.amo.fetch(s.ctx, s.heap, p, 0))
        s.keep(model)
    port = _same(script, npes=2, node_size=2)
    assert int(port.got[-2]) == port.got[-1]


# ---------------------------------------------------------------------------
# team collectives (test_collectives_core.py)
# ---------------------------------------------------------------------------


def _fill(s, p, rows):
    s.heap = s.heap.write_all(p, s.arr(rows, p.dtype))


def test_broadcast_team():
    def script(s):
        p = s.heap.malloc((8,), "float32")
        _fill(s, p, np.repeat(np.arange(8.0)[:, None], 8, 1))
        s.heap = s.coll.broadcast(s.ctx, s.heap, p, root=1,
                                  team=s.teams.Team(2, 1, 4))
        s.keep(s.heap.read_all(p)[:, 0])
    port = _same(script)
    want = [3.0 if 2 <= pe <= 5 else float(pe) for pe in range(8)]
    assert port.got[0].tolist() == want


def test_fcollect_and_collect():
    def script(s):
        src = s.heap.malloc((2,), "float32")
        dst = s.heap.malloc((16,), "float32")
        _fill(s, src, np.arange(16.0).reshape(8, 2))
        s.heap = s.coll.fcollect(s.ctx, s.heap, dst, src, s.ctx.team_world,
                                 work_items=64)
        src4 = s.heap.malloc((4,), "float32")
        dst32 = s.heap.malloc((32,), "float32")
        _fill(s, src4, np.repeat(np.arange(8.0)[:, None], 4, 1))
        s.heap = s.coll.collect(s.ctx, s.heap, dst32, src4, [1, 2, 0, 3],
                                s.teams.Team(0, 1, 4))
        s.keep(s.heap.read(dst, 5))
        s.keep(s.heap.read(dst32, 2)[:6])
    port = _same(script)
    assert port.got[0].tolist() == list(np.arange(16.0))
    assert port.got[1].tolist() == [0, 1, 1, 3, 3, 3]


@pytest.mark.parametrize("op,dtype", [
    ("sum", "float32"), ("max", "float32"), ("min", "float32"),
    ("prod", "float32"), ("sum", "bfloat16"), ("and", "int32"),
    ("or", "int32"), ("xor", "int32"), ("sum", "int32")])
def test_reduce_every_op(op, dtype):
    rng = np.random.RandomState(0)
    rows = (rng.randint(0, 255, (8, 6)) if dtype == "int32"
            else rng.uniform(0.5, 1.5, (8, 6)))

    def script(s):
        p = s.heap.malloc((6,), dtype)
        _fill(s, p, rows)
        s.heap = s.coll.reduce(s.ctx, s.heap, p, p, op, s.ctx.team_world)
        s.keep(s.heap.read(p, 3))
    _same(script)


def test_reduce_subteam_and_ring_record():
    """A strided sub-team leaves non-members untouched; a buffer above
    RING_REDUCE_BYTES records the ring algorithm."""
    def script(s):
        p = s.heap.malloc((2,), "float32")
        _fill(s, p, np.ones((8, 2)))
        s.heap = s.coll.reduce(s.ctx, s.heap, p, p, "sum",
                               s.teams.Team(0, 2, 4))
        s.keep(s.heap.read(p, 0))
        s.keep(s.heap.read(p, 1))
        big = s.heap.malloc((300_000,), "float32")
        s.heap = s.coll.reduce(s.ctx, s.heap, big, big, "max",
                               s.teams.Team(4, 1, 4), work_items=256)
    port = _same(script)
    assert [float(v[0]) for v in port.got] == [4.0, 1.0]
    assert [r[0] for r in port.records()] == ["reduce[flat]", "reduce[ring]"]


def test_alltoall():
    def script(s):
        team = s.teams.Team(0, 1, 4)
        src = s.heap.malloc((8,), "float32")
        dst = s.heap.malloc((8,), "float32")
        _fill(s, src, np.concatenate([np.arange(32.0).reshape(4, 8),
                                      np.zeros((4, 8))]))
        s.heap = s.coll.alltoall(s.ctx, s.heap, dst, src, team)
        s.keep(s.heap.read(dst, 1))
    port = _same(script)
    want = np.arange(32.0).reshape(4, 4, 2)[:, 1].reshape(-1)
    assert port.got[0].tolist() == want.tolist()


def test_sync_barrier_and_path_cutover():
    def script(s):
        ctr = s.heap.malloc((), "int32")
        s.heap, sat = s.coll.sync(s.ctx, s.heap, ctr, s.ctx.team_shared(4))
        s.keep(sat)
        q = s.heap.malloc((128,), "float32")
        s.heap = s.rma.put_nbi(s.ctx, s.heap, q, s.arr(np.ones(128)), 6)
        s.heap, sat = s.coll.barrier(s.ctx, s.heap, ctr, s.ctx.team_world)
        s.keep(sat)
        s.keep(s.heap.read(q, 6))
        small = s.heap.malloc((128,), "float32")
        large = s.heap.malloc((1 << 23,), "float32")
        for ptr in (small, large):
            s.heap = s.coll.broadcast(s.ctx, s.heap, ptr, 0,
                                      s.ctx.team_world, work_items=256)
    port = _same(script)
    assert port.got[0].tolist() == [True] * 4 and bool(port.got[1].all())
    paths = [r[2] for r in port.records() if r[0] == "broadcast"]
    assert paths == ["direct", "engine"]
    assert {"quiet", "sync"} <= {r[0] for r in port.records()}


def test_collectives_reject_bad_sizes():
    ctx, heap = context.init(npes=4, device="cpu")
    a, b = heap.malloc((3,), "float32"), heap.malloc((8,), "float32")
    with pytest.raises(ValueError):
        coll.fcollect(ctx, heap, b, a, ctx.team_world)
    with pytest.raises(ValueError):
        coll.alltoall(ctx, heap, b, a, ctx.team_world)


# ---------------------------------------------------------------------------
# RMA and signal additions
# ---------------------------------------------------------------------------


def test_g_iput_iget_put_signal():
    def script(s):
        buf = s.heap.malloc((64,), "float32")
        sig = s.heap.malloc((), "int32")
        s.heap = s.rma.p(s.ctx, s.heap, buf.index(7), 42.0, 3)
        s.keep(s.rma.g(s.ctx, s.heap, buf.index(7), 3, src_pe=5))
        s.heap = s.rma.put_nbi(s.ctx, s.heap, buf, s.arr(np.arange(64.0)), 2)
        s.heap = s.rma.iput(s.ctx, s.heap, buf, s.arr(np.arange(20.0) * -1),
                            2, dst_stride=3, src_stride=2)
        s.keep(s.heap.read(buf, 2))
        s.keep(s.rma.iget(s.ctx, s.heap, buf, 2, src_stride=5, nelems=7))
        s.heap = s.sig.put_signal_nbi(s.ctx, s.heap, buf, s.arr(np.ones(64)),
                                      sig, 2, s.sig.SIGNAL_ADD, 6)
        s.heap = s.sig.put_signal(s.ctx, s.heap, buf, s.arr(np.full(64, 3.0)),
                                  sig, 5, s.sig.SIGNAL_ADD, 6, src_pe=1,
                                  work_items=32)
        s.keep(s.sig.signal_fetch(s.ctx, s.heap, sig, 6))
        s.keep(s.heap.read(buf, 6))
        s.keep(len(s.ctx.pending))
    port = _same(script)
    assert float(port.got[0]) == 42.0 and int(port.got[3]) == 7


def test_iput_refuses_an_overrun():
    ctx, heap = context.init(npes=2, device="cpu")
    buf = heap.malloc((8,), "float32")
    with pytest.raises(IndexError):
        rma.iput(ctx, heap, buf, torch.ones(4), 1, dst_stride=3)


def test_quiet_with_a_proxy_raises():
    """``quiet(proxy=...)`` is ported: a dcn-tier put travels the proxy's
    ring and drains (``rma.quiet`` and the facade alike).  What still
    raises is a proxy that is not one, once a dcn put needs its ring."""
    from repro_torch.core.proxy import HostProxy
    ctx, heap = context.init(npes=2, node_size=1, device="cpu")
    buf = heap.malloc((4,), "float32")
    heap = rma.put_nbi(ctx, heap, buf, torch.ones(4), 1)
    with pytest.raises(AttributeError):
        rma.quiet(ctx, heap, proxy=object())
    px = HostProxy(ctx)
    heap = rma.quiet(ctx, heap, proxy=px)
    assert heap.read(buf, 1).tolist() == [1.0] * 4
    assert len(px.ring.delivered) == 1
    sh = Ishmem(npes=2, node_size=1, device="cpu")
    buf = sh.ishmem_malloc((4,), "float32")
    sh.heap = rma.put_nbi(sh.ctx, sh.heap, buf, torch.full((4,), 2.0), 1)
    px = HostProxy(sh.ctx)
    sh.ishmem_quiet(proxy=px)
    assert sh.heap.read(buf, 1).tolist() == [2.0] * 4
    assert len(px.ring.delivered) == 1


# ---------------------------------------------------------------------------
# teams (test_teams.py), on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [teams, ref_teams], ids=["port", "ref"])
def test_teams_laws(mod):
    t = mod.Team(1, 2, 4)
    assert t.pes() == [1, 3, 5, 7] and t.translate(2) == 5
    assert [t.rank_of(p) for p in (7, 2, 9)] == [3, -1, -1]
    child = mod.world(16).split_strided(0, 2, 8)
    assert child.split_strided(1, 2, 4).pes() == [2, 6, 10, 14]
    assert mod.shared(12, node_size=4, node_id=2).pes() == [8, 9, 10, 11]
    pods = mod.pods_partition(mod.world(10), [5, 2, 2])
    assert [p.pes() for p in pods] == [[0, 1, 2, 3, 4], [5, 6], [7, 8]]
    pre, dec = mod.disagg_partition(mod.shared(16, 8, 1), 4)
    assert pre.pes() == [8, 9, 10, 11] and dec.pes() == [12, 13, 14, 15]
    for bad in (lambda: mod.shared(12, 4, 3),
                lambda: child.split_strided(0, 4, 4),
                lambda: mod.world(8).split_strided(7, 1, 2),
                lambda: mod.pods_partition(mod.world(8), []),
                lambda: mod.pods_partition(mod.world(8), [4, 0]),
                lambda: mod.pods_partition(mod.world(8), [5, 4]),
                lambda: mod.disagg_partition(
                    mod.pods_partition(mod.world(4), [1, 3])[0], 1),
                lambda: mod.Team(0, 1, 4).translate(4)):
        with pytest.raises(ValueError):
            bad()


def test_team_accessors_match_reference():
    ctx, _ = context.init(npes=12, node_size=4, device="cpu")
    rctx, _ = ref_context.init(npes=12, node_size=4)
    assert ctx.team_world == teams.Team(*rctx.team_world.__dict__.values())
    for pe in (0, 5, 11):
        assert ctx.team_shared(pe).pes() == rctx.team_shared(pe).pes()


# ---------------------------------------------------------------------------
# the Ishmem facade (test_ishmem_api.py)
# ---------------------------------------------------------------------------


def _facade(script):
    return _same(script, npes=8, node_size=4, facade=True)


def test_facade_paper_listing_and_amos():
    def script(s):
        sh = s.sh
        buf = sh.ishmem_malloc((256,), "float32")
        sh.ishmem_p(buf.index(7), 42.0, pe=3)
        s.keep(sh.ishmem_g(buf.index(7), pe=3))
        sh.ishmemx_put_work_group(buf, s.arr(np.arange(256.0)), pe=1,
                                  work_group_size=1024)
        s.keep(sh.ishmemx_get_work_group(buf, pe=1))
        ctr = sh.ishmem_malloc((), "int32")
        s.keep(sh.ishmem_atomic_fetch_add(ctr, 5, pe=2))
        sh.ishmem_atomic_inc(ctr, pe=2)
        s.keep(sh.ishmem_atomic_fetch(ctr, pe=2))
        s.keep(sh.ishmem_atomic_compare_swap(ctr, 6, 9, pe=2))
        sh.ishmem_atomic_set(ctr, 1, pe=4)
        sh.ishmem_atomic_add_nbi(ctr, 2, pe=4)
        sig = sh.ishmem_malloc((), "int32")
        sh.ishmem_put_signal(buf, s.arr(np.ones(256)), sig, 1,
                             s.sig.SIGNAL_ADD, pe=5)
        cur, ok = sh.ishmem_signal_wait_until(sig, 5, "ge", 1)
        s.keep(cur)
        s.keep(bool(ok))
        sh.ishmem_put_signal_nbi(buf, s.arr(np.full(256, 2.0)), sig, 4,
                                 s.sig.SIGNAL_SET, pe=6)
        s.keep(sh.ishmem_pending_ops())
        cur, ok = sh.ishmem_signal_wait_until(sig, 6, "eq", 4)
        s.keep(bool(ok))
        sh.ishmem_quiet()
        s.keep(sh.ishmem_atomic_fetch(ctr, pe=4))
    port = _facade(script)
    assert float(port.got[0]) == 42.0 and int(port.got[-1]) == 3


def test_facade_collectives_nbi_and_free():
    def script(s):
        sh = s.sh
        buf = sh.ishmem_malloc((16,), "float32")
        sh.heap = sh.heap.write_all(buf, s.arr(np.ones((8, 16))))
        sh.ishmemx_sum_reduce_work_group(buf, buf, sh.ctx.team_shared(0),
                                         work_group_size=256)
        s.keep(sh.ishmem_barrier_all())
        s.keep(sh.ishmem_team_sync(sh.ctx.team_shared(4)))
        sh.ishmemx_broadcast_work_group(buf, 2, work_group_size=64)
        src = sh.ishmem_malloc((2,), "float32")
        dst = sh.ishmem_malloc((16,), "float32")
        sh.heap = sh.heap.write_all(src, s.arr(np.arange(16.0).reshape(8, 2)))
        sh.ishmemx_fcollect_work_group(dst, src, work_group_size=32)
        sh.ishmem_max_reduce(src, src)
        a2a = sh.ishmem_malloc((16,), "float32")
        sh.ishmem_alltoall(a2a, dst)
        nb = sh.ishmem_malloc((128,), "float32")
        sh.ishmem_put_nbi(nb, s.arr(np.full(128, 2.0)), pe=6)
        sh.ishmem_fence()
        s.keep(sh.ishmem_get_nbi(nb, pe=6))
        sh.ishmem_quiet()
        s.keep(sh.ishmem_get(nb, pe=6))
        s.keep(sh.ishmemx_barrier_all_work_group())
        a = sh.ishmem_malloc((128,), "float32")
        sh.ishmem_free(a)
        s.keep(sh.ishmem_calloc((64,), "float32").offset == a.offset)
        s.keep(sh.ishmem_n_pes())
        s.keep(sh.ishmem_team_n_pes(sh.ctx.team_shared(0)))
    port = _facade(script)
    assert port.got[-3:] == [True, 8, 4]


def test_facade_runs_where_asked():
    sh = Ishmem(npes=2, device="cpu")
    assert sh.heap.device == torch.device("cpu")
