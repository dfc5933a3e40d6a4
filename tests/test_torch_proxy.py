"""The port's reverse-offload ring, host proxy and the completion queue's
fault laws, held against the JAX package.

Mirrors ``tests/test_ring_buffer.py`` (the ring's step machine, driven
through the same schedules on both packages' rings, whose whole state must
agree), ``tests/test_proxy.py`` and the proxy and dead-PE laws of
``tests/test_pending.py``.  Each proxy script runs on both packages (CPU
heaps) from the same numpy inputs and must agree exactly: every pool byte,
every returned value and ring completion, the ring's counters, the queue's
``errors`` records and stats, and the sequence of ``(op, nbytes, path,
tier, work_items, t_sec)`` telemetry records.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # clean interpreter: deterministic fallback
    from _minihyp import given, settings, strategies as st

from repro.core import amo as ref_amo, context as ref_context, \
    proxy as ref_proxy, ring as ref_ring, rma as ref_rma, \
    signal as ref_signal
from repro.core.heap import SymPtr as RefSymPtr
from repro_torch import _bridge
from repro_torch.core import amo, context, proxy, ring, rma, signal
from repro_torch.core.heap import SymPtr
from repro_torch.kernels import ops
from _torch_threads import one_intra_op_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the ring (test_ring_buffer.py): both rings step through one schedule
# ---------------------------------------------------------------------------


def _ring_state(r):
    return {"write_reserve": r.write_reserve,
            "consumed_published": r.consumed_published,
            "slot_tag": list(r.slot_tag), "read_index": r.read_index,
            "delivered": [(i, m.op, m.payload) for i, m in r.delivered],
            "completions": dict(r.completions),
            "prod": {p: (s, i) for p, (s, i, _) in r._prod.items()},
            "spin_count": r.spin_count, "store_ops": r.store_ops,
            "publish_ops": r.publish_ops,
            "overwrite_errors": r.overwrite_errors,
            "overhead": r.flow_control_overhead()}


def _both(fn, **kw):
    """Run ``fn(ring_module, ring)`` on a reference ring and a port ring
    built alike; their whole state must agree.  Returns the port's ring."""
    rings = [ref_ring.RingBuffer(**kw), ring.RingBuffer(**kw)]
    for mod, r in zip((ref_ring, ring), rings):
        fn(mod, r)
    assert _ring_state(rings[0]) == _ring_state(rings[1])
    return rings[1]


def _drive_schedule(r, producers, schedule):
    """test_ring_buffer.py::drive_schedule: interleave producer and
    consumer micro-steps per schedule, then drain."""
    for actor in schedule:
        if actor == -1:
            r.consumer_step()
        else:
            r.producer_step(producers[actor % len(producers)])
    for _ in range(10_000):
        progressed = False
        for pid in list(producers):
            if r.producer_step(pid) is not None:
                progressed = True
        if r.consumer_step() is not None:
            progressed = True
        if r.read_index == r.write_reserve and not any(
                r._prod[p][0] < 3 for p in r._prod):
            break
        if not progressed and r.read_index == r.write_reserve:
            break
    r.publish()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 6), st.integers(1, 40),
       st.lists(st.integers(-1, 5), max_size=200), st.sampled_from([4, 8, 16]))
def test_ring_exactly_once_in_order(n_producers, n_msgs, schedule, slots):
    def fn(mod, r):
        producers = []
        for m in range(n_msgs):
            pid = f"p{m % n_producers}_{m}"
            r.start(pid, mod.Message("put", payload=m.to_bytes(4, "little")))
            producers.append(pid)
        _drive_schedule(r, producers, schedule)

    r = _both(fn, slots=slots, publish_every=4)
    assert r.overwrite_errors == 0
    idxs = [i for i, _ in r.delivered]
    assert idxs == sorted(idxs) == list(range(len(idxs))) and \
        len(idxs) == n_msgs
    assert sorted(int.from_bytes(m.payload, "little")
                  for _, m in r.delivered) == list(range(n_msgs))


def test_ring_flow_control_blocks_when_full():
    def fn(mod, r):
        pids = [f"p{i}" for i in range(6)]
        for pid in pids:
            r.start(pid, mod.Message("put"))
        for pid in pids:
            r.producer_step(pid)
        assert sum(1 for p in pids if r._prod[p][0] >= 1) == 4
        assert r.spin_count >= 2
        for pid in pids:
            r.producer_step(pid)
            r.producer_step(pid)
        for _ in range(4):
            r.consumer_step()
        r.publish()
        for pid in pids:
            for _ in range(3):
                r.producer_step(pid)
        while r.consumer_step() is not None:
            pass

    r = _both(fn, slots=4, publish_every=1)
    assert len(r.delivered) == 6 and r.overwrite_errors == 0


def test_ring_out_of_order_completions():
    def fn(mod, r):
        r.start("a", mod.Message("put"))
        r.start("b", mod.Message("put"))
        for pid in ("a", "b"):
            while r.producer_step(pid) is None:
                pass
        r.consumer_step()
        r.consumer_step()
        assert r.producer_done("b") and r.producer_done("a")

    _both(fn, slots=8)


def test_ring_message_size_limit():
    for mod in (ref_ring, ring):
        with pytest.raises(ValueError):
            mod.Message("put", payload=b"x" * 57)
        assert mod.Message("put", payload=b"x" * 56).payload == b"x" * 56


def test_ring_flow_control_off_critical_path():
    def fn(mod, r):
        for m in range(512):
            pid = f"p{m}"
            r.start(pid, mod.Message("put"))
            while r.producer_step(pid) is None:
                if r.spin_count > 0:
                    r.consumer_step()
            r.consumer_step()
        while r.consumer_step() is not None:
            pass

    r = _both(fn, slots=64, publish_every=16)
    assert r.flow_control_overhead() < 0.05 and len(r.delivered) == 512


# ---------------------------------------------------------------------------
# the proxy and the queue: one script, both packages
# ---------------------------------------------------------------------------


class _Side:
    """One package's modules, context and heap, driven by a script."""

    def __init__(self, ref: bool, npes=4, node_size=2):
        self.ref = ref
        if ref:
            self.amo, self.proxy, self.rma, self.sig = (
                ref_amo, ref_proxy, ref_rma, ref_signal)
            self.SymPtr = RefSymPtr
            self.ctx, self.heap = ref_context.init(npes=npes,
                                                   node_size=node_size)
        else:
            self.amo, self.proxy, self.rma, self.sig = amo, proxy, rma, signal
            self.SymPtr = SymPtr
            self.ctx, self.heap = context.init(npes=npes, node_size=node_size,
                                               device="cpu")
        self.got = []
        self.px = []

    def arr(self, x, dtype="float32"):
        x = np.asarray(x)
        return jnp.asarray(x).astype(dtype) if self.ref else \
            torch.from_numpy(x).to(getattr(torch, dtype))

    def full(self, n, v, dtype="float32"):
        return self.arr(np.full(n, v), dtype)

    def host_proxy(self, **kw):
        px = self.proxy.HostProxy(self.ctx, **kw)
        self.px.append(px)
        return px

    def keep(self, v):
        if isinstance(v, (bool, int, float, str, tuple, list, dict)):
            self.got.append(v)
        elif self.ref:
            self.got.append(_bridge.array_to_torch(np.asarray(v), "cpu"))
        else:
            self.got.append(v.detach().cpu().clone())

    def pools(self):
        return {dt: _bridge.array_to_torch(np.asarray(p), "cpu")
                if self.ref else p for dt, p in self.heap.pools.items()}

    def records(self):
        return [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
                for r in self.ctx.telemetry.trace]

    def rings(self):
        out = []
        for px in self.px:
            st = _ring_state(px.ring)
            st["completions"] = {k: None if v is None else int(v)
                                 for k, v in st["completions"].items()}
            out.append((st, px.backpressure, sorted(px._staging)))
        return out


def _same(script, **kw):
    """Run ``script(side)`` on both packages and require exact agreement
    (the module docstring).  Returns the port's side."""
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
    assert ref.rings() == port.rings()
    assert ref.ctx.pending.errors == port.ctx.pending.errors
    assert dataclasses.asdict(ref.ctx.pending.stats) == \
        dataclasses.asdict(port.ctx.pending.stats)
    assert len(ref.ctx.pending) == len(port.ctx.pending)
    assert len(ref.got) == len(port.got)
    for a, b in zip(ref.got, port.got):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.reshape(a.shape))
        else:
            assert a == b
    return port


# --- test_proxy.py ---------------------------------------------------------


def test_proxy_put_is_deferred_until_drain():
    def script(s):
        p = s.heap.malloc((64,), "float32")
        px = s.host_proxy()
        px.put(p, s.arr(np.ones(64)), 3)
        s.keep(float(s.heap.read(p, 3).sum()))          # not yet executed
        s.heap = px.drain(s.heap)
        s.keep(float(s.heap.read(p, 3).sum()))
        s.keep(len(px.ring.delivered))
    port = _same(script)
    assert port.got == [0.0, 64.0, 1]


def test_proxy_amo_add_via_ring_with_completion():
    def script(s):
        p = s.heap.malloc((), "int32")
        px = s.host_proxy()
        _, idx1 = px.amo_add(p, 5, 2)
        _, idx2 = px.amo_add(p, 7, 2)
        s.heap = px.drain(s.heap)
        s.keep(int(s.heap.read(p, 2).reshape(())))
        s.keep([int(px.ring.completions[idx1]),
                int(px.ring.completions[idx2])])
    assert _same(script).got == [12, [0, 5]]


def test_proxy_many_messages_wrap_ring():
    def script(s):
        p = s.heap.malloc((256,), "float32")
        px = s.host_proxy(slots=8)
        for i in range(5):                 # submit, drain, repeat (laps)
            for j in range(6):
                px.put(p, s.full(256, float(i * 6 + j)), 1)
            s.heap = px.drain(s.heap)
        s.keep(px.ring.overwrite_errors)
        s.keep(len(px.ring.delivered))
        s.keep(float(s.heap.read(p, 1)[0]))
    assert _same(script).got == [0, 30, 29.0]


def test_proxy_quiet_message():
    def script(s):
        px = s.host_proxy()
        px.quiet()
        s.heap = px.drain(s.heap)
        s.keep(any(r.op == "proxy_quiet" for r in s.ctx.ledger))
    assert _same(script, npes=2, node_size=1).got == [True]


def test_proxy_submit_wedges_when_ring_full_and_no_consumer():
    def script(s):
        px = s.host_proxy(slots=4)
        p = s.heap.malloc((8,), "float32")
        for i in range(4):                  # fill every slot, never drain
            px.put(p, s.full(8, float(i)), 1)
        before = px.ring.spin_count
        with pytest.raises(RuntimeError, match="ring wedged"):
            px.put(p, s.full(8, 0.0), 1)
        s.keep(px.ring.spin_count > 10_000 and px.ring.spin_count > before)
        s.keep(len(px.ring._prod))          # the wedged producer is gone
        s.heap = px.drain(s.heap)
        s.keep(len(px.ring.delivered))
        px.put(p, s.full(8, 9.0), 2)        # the ring takes new traffic
        s.heap = px.drain(s.heap)
        s.keep(float(s.heap.read(p, 2)[0]))
    assert _same(script).got == [True, 4, 4, 9.0]


def test_proxy_drain_reaps_multiple_outstanding_producers():
    def script(s):
        px = s.host_proxy(slots=16)
        p = s.heap.malloc((4,), "float32")
        ids = [px.put(p, s.full(4, float(i)), i % 4) for i in range(10)]
        s.keep((len(px.ring._prod), len(px.ring.completions)))
        s.heap = px.drain(s.heap)
        s.keep((len(px.ring.delivered), len(px.ring._prod)))
        s.keep(sorted(px.ring.completions) == sorted(i for _, i in ids))
        s.keep([float(s.heap.read(p, pe)[0]) for pe in range(4)])
    assert _same(script).got == [(10, 0), (10, 0), True,
                                 [8.0, 9.0, 6.0, 7.0]]


def test_proxy_amo_add_returns_pre_image_per_message():
    def script(s):
        px = s.host_proxy()
        p = s.heap.malloc((), "int32")
        idxs = [px.amo_add(p, v, 1)[1] for v in (3, 11, -4, 7)]
        s.heap = px.drain(s.heap)
        s.keep([int(px.ring.completions[i]) for i in idxs])
        s.keep(int(s.heap.read(p, 1).reshape(())))
    assert _same(script).got == [[0, 3, 14, 10], 17]


def test_proxy_amo_add_pre_image_interleaved_with_puts():
    def script(s):
        px = s.host_proxy()
        p = s.heap.malloc((), "int32")
        _, i1 = px.amo_add(p, 5, 1)
        px.put(p, s.arr(100, "int32"), 1)      # FIFO: after the add
        _, i2 = px.amo_add(p, 2, 1)
        s.heap = px.drain(s.heap)
        s.keep([int(px.ring.completions[i1]), int(px.ring.completions[i2])])
        s.keep(int(s.heap.read(p, 1).reshape(())))
    assert _same(script, npes=2, node_size=1).got == [[0, 100], 102]


# --- the proxy and dead-PE laws of test_pending.py ---------------------------


@settings(max_examples=8, deadline=None)
@given(st.sampled_from(["fd", "df", "fdf", "dfd"]), st.integers(1, 50))
def test_proxy_and_nbi_drain_order_converges(schedule, val):
    """The nbi queue and the ring are independent channels to disjoint
    targets: any order of (f)lush and (d)rain gives the same heap."""
    finals = []
    for order in (schedule, schedule[::-1]):
        def script(s):
            a = s.heap.malloc((16,), "float32")
            b = s.heap.malloc((16,), "float32")
            px = s.host_proxy()
            s.heap = s.rma.put_nbi(s.ctx, s.heap, a, s.full(16, float(val)),
                                   1)
            px.put(b, s.full(16, float(val + 1)), 3)
            for step in order:
                s.heap = (s.rma.quiet(s.ctx, s.heap) if step == "f"
                          else px.drain(s.heap))
            s.keep(s.heap.read(a, 1))
            s.keep(s.heap.read(b, 3))
        finals.append(torch.cat(_same(script).got))
    assert torch.equal(finals[0], finals[1])


def test_proxy_put_nbi_rides_queue_and_completes_at_quiet():
    def script(s):
        p = s.heap.malloc((16,), "float32")
        px = s.host_proxy()
        px.put_nbi(p, s.full(16, 5.0), 3)               # cross-pod, deferred
        s.keep((float(s.heap.read(p, 3).sum()), len(px.ring.delivered)))
        s.heap = s.rma.quiet(s.ctx, s.heap, proxy=px)   # ring + drain
        s.keep((float(s.heap.read(p, 3)[0]), len(px.ring.delivered)))
    assert _same(script).got == [(0.0, 0), (5.0, 1)]


def test_proxy_flush_orders_ring_puts_before_later_amos():
    """A dcn nbi put then a deferred AMO on the same element: the flush
    drains the ring before the AMO, which reads the put's value."""
    def script(s):
        p = s.heap.malloc((), "int32")
        px = s.host_proxy()
        px.put_nbi(p, s.arr(10, "int32"), 3)
        s.heap = s.amo.add_nbi(s.ctx, s.heap, p, 5, 3)
        s.heap = s.rma.quiet(s.ctx, s.heap, proxy=px)
        s.keep(int(s.heap.read(p, 3).reshape(())))
    assert _same(script).got == [15]


def test_dead_pe_ops_cancel_instead_of_wedging_quiet():
    def script(s):
        p = s.heap.malloc((32,), "float32")
        s.heap = s.rma.put_nbi(s.ctx, s.heap, p, s.full(32, 1.0), 1)
        s.heap = s.rma.put_nbi(s.ctx, s.heap, p, s.full(32, 2.0), 2)
        s.ctx.fault.kill(1)
        s.keep(s.ctx.pending.cancel_pe(s.ctx, 1))
        s.heap = s.rma.quiet(s.ctx, s.heap)             # completes
        s.keep(s.heap.read(p, 2))
        s.keep(float(s.heap.read(p, 1).sum()))
    port = _same(script)
    assert port.got[0] == 1 and port.got[2] == 0.0
    assert port.ctx.pending.stats.cancelled == 1
    assert port.ctx.pending.errors[0]["pe"] == 1 and \
        "died" in port.ctx.pending.errors[0]["reason"]


def test_ops_queued_after_death_cancel_at_flush():
    def script(s):
        p = s.heap.malloc((16,), "float32")
        s.ctx.fault.kill(3)
        s.heap = s.rma.put_nbi(s.ctx, s.heap, p, s.full(16, 1.0), 3)
        s.heap = s.rma.quiet(s.ctx, s.heap)
    port = _same(script)
    assert port.ctx.pending.errors[0]["reason"] == \
        "peer died with op in flight"
    assert any(r.op == "put_nbi(cancelled)" for r in port.ctx.ledger)


def test_dead_source_pe_cancels_op():
    def script(s):
        p = s.heap.malloc((16,), "float32")
        s.heap = s.rma.put_nbi(s.ctx, s.heap, p, s.full(16, 1.0), 2,
                               src_pe=1)
        s.heap = s.sig.put_signal_nbi(
            s.ctx, s.heap, p, s.full(16, 3.0), s.SymPtr("int32", 0, ()), 1,
            s.sig.SIGNAL_ADD, 3, src_pe=1)
        s.ctx.fault.kill(1)
        s.keep(s.ctx.pending.cancel_pe(s.ctx, 1))
        s.heap = s.rma.quiet(s.ctx, s.heap)
        s.keep(float(s.heap.read(p, 2).sum()))
    port = _same(script)
    assert port.got == [3, 0.0]
    assert [e["src_pe"] for e in port.ctx.pending.errors] == [1, 1, 1]


def test_partition_parks_dcn_ops_until_heal():
    """Cross-pod ops are neither delivered nor lost while the fabric is
    partitioned, with and without a proxy; healing drains them in order."""
    def script(s):
        near = s.heap.malloc((16,), "float32")
        far = s.heap.malloc((16,), "float32")
        px = s.host_proxy()
        s.ctx.fault.dcn_down = True
        s.heap = s.rma.put_nbi(s.ctx, s.heap, near, s.full(16, 1.0), 1)
        s.heap = s.rma.put_nbi(s.ctx, s.heap, far, s.full(16, 9.0), 3)
        s.heap = s.rma.put_nbi(s.ctx, s.heap, near, s.full(16, 4.0), 0)
        s.heap = s.rma.quiet(s.ctx, s.heap, proxy=px)   # no wedge
        s.keep((float(s.heap.read(near, 1).sum()),
                float(s.heap.read(far, 3).sum()), len(s.ctx.pending)))
        s.ctx.fault.dcn_down = False
        s.heap = s.rma.quiet(s.ctx, s.heap, proxy=px)
        s.keep((float(s.heap.read(far, 3).sum()),
                float(s.heap.read(near, 0).sum()), len(s.ctx.pending),
                len(px.ring.delivered)))
    port = _same(script)
    assert port.got == [(16.0, 0.0, 2), (144.0, 64.0, 0, 1)]
    assert port.ctx.pending.stats.cancelled == 0


def test_ring_backpressure_drains_a_full_ring_mid_flush():
    """With write combining off, every dcn put is its own ring message: a
    2-slot ring fills mid-flush and the flush drains it (backpressure)
    instead of wedging, exactly as the reference does."""
    def script(s):
        s.ctx.tuning = dataclasses.replace(s.ctx.tuning, nbi_coalesce=False)
        p = s.heap.malloc((64,), "float32")
        px = s.host_proxy(slots=2)
        for i in range(5):
            s.heap = s.rma.put_nbi(
                s.ctx, s.heap, s.SymPtr("float32", p.offset + 8 * i, (8,)),
                s.full(8, float(i + 1)), 3)
        s.heap = s.rma.quiet(s.ctx, s.heap, proxy=px)
        s.keep(s.heap.read(p, 3))
        s.keep(px.backpressure)
    port = _same(script)
    assert port.got[1] >= 1
    assert port.got[0][:40].tolist() == sum(([float(i + 1)] * 8
                                             for i in range(5)), [])
