"""Host proxy: executes reverse-offloaded device ops (paper §III-C/D).

Counterpart of ``repro/core/proxy.py``.  When a device-initiated op
targets a PE that is not directly reachable over the fabric (the ``dcn``
tier: a remote pod), the device composes a fixed 64-byte request message,
pushes it through the lock-free ring (``core/ring.py``) and the host proxy
thread executes it on the host-initiated path, posting a completion.

The proxy is a real consumer of the ring protocol: ops are deferred at
submit time and change the heap only when the proxy drains the ring.  The
message header is ``struct``-packed as in the reference; a payload larger
than the 56 inline bytes stays staged as a tensor on the heap's device (the
registered device memory the NIC reads directly), and each drained put is
one ``SymmetricHeap.write``, so one K1 launch on a CUDA heap.
"""
from __future__ import annotations

import struct

import torch

from repro_torch.core import ring as ring_mod
from repro_torch.core.heap import TORCH_DTYPES, SymPtr

# op codes in the 64-byte message
OP_PUT, OP_GET, OP_AMO_ADD, OP_AMO_CSWAP, OP_QUIET = range(5)
_DTYPES = ["float32", "int32", "int64", "uint32", "float64", "uint64",
           "int8", "uint8", "float16", "bfloat16"]
# op, dtype, _, pe, offset, size (20 B): offset int64, size int32, so a
# 302 M-word pool row and a coalesced run of its blocks both fit
_HDR = struct.Struct("<BBHiqi")


class HostProxy:
    def __init__(self, ctx, slots: int = 128):
        self.ctx = ctx
        self.ring = ring_mod.RingBuffer(slots=slots)
        self._staging = {}       # msg idx -> payload too big for 56 B inline
        self._pid = 0
        self.backpressure = 0    # producer waits absorbed by a mid-run drain

    def ring_full(self) -> bool:
        """True when the next submit would spin on flow control: every slot
        looks occupied against the (possibly stale) published consumed
        count.  A caller holding the heap drains and retries (the
        backpressure path of ``CompletionQueue._issue``)."""
        return (self.ring.write_reserve - self.ring.consumed_published
                >= self.ring.slots)

    # ------------------------------------------------------------- submit
    def _submit(self, op, ptr: SymPtr, pe, data=None):
        hdr = _HDR.pack(op, _DTYPES.index(ptr.dtype), 0, pe, ptr.offset,
                        ptr.size)
        pid = f"wi{self._pid}"
        self._pid += 1
        msg = ring_mod.Message(op=str(op), payload=hdr)
        self.ring.start(pid, msg)
        # drive this producer until the message is visible; wedge detection
        # is relative to THIS submit (the spin counter is cumulative)
        idx = None
        spins_at_start = self.ring.spin_count
        while idx is None:
            idx = self.ring.producer_step(pid)
            if idx is None and self.ring.spin_count - spins_at_start > 10_000:
                self.ring._prod.pop(pid, None)   # abandon, don't leak the pid
                raise RuntimeError("ring wedged: no consumer progress")
        if data is not None:
            self._staging[idx] = data
        return pid, idx

    @staticmethod
    def _payload(ptr: SymPtr, value) -> torch.Tensor:
        """``value`` flat in the pointer's dtype, on the device it lies on
        (a Python value on the CPU; the drain's store moves it to the
        heap).  Heap views need no copy: no data op mutates a pool."""
        return torch.as_tensor(value, dtype=TORCH_DTYPES[ptr.dtype]) \
            .reshape(ptr.size).contiguous()

    def put(self, ptr: SymPtr, value, pe):
        """Reverse-offloaded put: one ring message, executed at drain."""
        return self._submit(OP_PUT, ptr, pe, data=self._payload(ptr, value))

    def put_nbi(self, ptr: SymPtr, value, pe, *, src_pe: int = -1):
        """Deferred reverse-offload put: parks on the context's completion
        queue as the same PendingOp every other nbi op uses (tier pinned to
        dcn); ``quiet(ctx, heap, proxy=self)`` routes it through the ring
        and drains, so it completes exactly at quiet.  The queue owns a
        copy of the payload."""
        from repro_torch.core import pending as pending_mod
        value = self._payload(ptr, value).clone()
        self.ctx.record("put_nbi(pending)", ptr.nbytes, "proxy", "dcn", 1,
                        t_sec=0.0)
        self.ctx.pending.submit(
            pending_mod.PUT, "put_nbi", ptr, pe, "dcn", src_pe=src_pe,
            value=value,
            marker=self.ctx.ledger[-1] if self.ctx.ledger else None)

    def amo_add(self, ptr: SymPtr, value, pe):
        return self._submit(OP_AMO_ADD, ptr, pe,
                            data=torch.as_tensor(value,
                                                 dtype=TORCH_DTYPES[ptr.dtype]))

    def quiet(self):
        return self._submit(OP_QUIET, SymPtr("int32", 0, ()), 0)

    # -------------------------------------------------------------- drain
    def drain(self, heap):
        """Host proxy thread: consume every visible message, executing each
        against the heap on the host-initiated path.  Returns the new
        heap."""
        state = {"heap": heap}

        def executor(msg):
            op, dt, _, pe, off, size = _HDR.unpack(msg.payload[:_HDR.size])
            ptr = SymPtr(_DTYPES[dt], off, (size,) if size else ())
            idx = self.ring.read_index
            if op == OP_PUT:
                data = self._staging.pop(idx)
                state["heap"] = state["heap"].write(ptr, pe, data)
                self.ctx.record("proxy_put", ptr.nbytes, "proxy", "dcn", 1)
            elif op == OP_AMO_ADD:
                data = self._staging.pop(idx)
                old = state["heap"].read(ptr, pe).clone()
                state["heap"] = state["heap"].write(
                    ptr, pe, old + data.to(old.device))
                self.ctx.record("proxy_amo", ptr.nbytes, "proxy", "dcn", 1)
                return old.reshape(()) if old.numel() == 1 else old
            elif op == OP_QUIET:
                self.ctx.record("proxy_quiet", 0, "proxy", "dcn", 1)
            return None

        while self.ring.consumer_step(executor) is not None:
            pass
        self.ring.publish()
        for pid in list(self.ring._prod):          # reap completions
            self.ring.producer_done(pid)
        return state["heap"]
