"""Deferred-completion engine: the queue behind every non-blocking op.

Counterpart of ``repro/core/pending.py``.  ``put_nbi``, ``get_nbi``,
``put_signal_nbi`` and the deferred AMOs do not touch the target row at
call time: they append a :class:`PendingOp` to the context's
:class:`CompletionQueue`, and the row changes only when a completion point
flushes the queue:

- ``quiet`` flushes everything;
- ``signal_wait_until`` flushes the queue prefix up to the last op on the
  waited word (put_signal orders data before flag);
- a blocking ``put`` to the same bytes supersedes fully covered pending puts
  and completes partial overlaps first (program order).

``fence`` closes an epoch: ops in different epochs never coalesce.  Write
combining happens at flush: queue-adjacent puts with the same (pe, dtype,
epoch) whose ranges abut or coincide merge into ONE transfer, and only then
does the cutover engine pick a path for the coalesced size; queue-adjacent
deferred adds to one element merge into one atomic.  Every transfer lands
through ``SymmetricHeap.write``, i.e. through the K1 copy kernel on a CUDA
heap.

dcn-tier puts are the same records: a flush given a
:class:`~repro_torch.core.proxy.HostProxy` submits them as ring messages
and drains the ring (so each lands through the same ``heap.write``), else
they complete on the modeled proxy path.  Fault laws: an op touching a dead
PE, as source or destination, cancels with a structured record on
``errors`` instead of completing (``cancel_pe`` at the kill, and at every
later flush), and while the dcn fabric is partitioned only the queue prefix
before the first cross-pod op completes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from repro_torch.core import cutover
from repro_torch.core.heap import TORCH_DTYPES, SymPtr

# PendingOp kinds
PUT, GET, AMO, SIGNAL = "put", "get", "amo", "signal"


@dataclasses.dataclass
class PendingOp:
    """One deferred operation."""
    kind: str                      # PUT | GET | AMO | SIGNAL
    op: str                        # ledger name ("put_nbi", "amo_add_nbi", ...)
    ptr: SymPtr
    pe: int
    tier: str
    epoch: int
    seq: int
    src_pe: int = -1               # initiating PE (-1: unknown or the host)
    work_items: int = 1
    value: Optional[torch.Tensor] = None    # PUT: flat payload, owned
    apply: Optional[Callable] = None        # AMO/SIGNAL: old -> new
    delta: Optional[object] = None          # AMO add: mergeable increment
    marker: Optional[object] = None         # the "(pending)" trace OpRecord

    @property
    def end(self) -> int:
        return self.ptr.offset + self.ptr.size


@dataclasses.dataclass
class FlushStats:
    """Per-queue lifetime counters (coalescing ratio = ops / transfers)."""
    submitted: int = 0
    flushed_ops: int = 0
    transfers: int = 0
    flushed_bytes: int = 0
    transfer_bytes: int = 0
    flushes: int = 0
    cancelled: int = 0             # ops cancelled with an error (dead peer)

    def coalescing_ratio(self) -> float:
        return self.flushed_ops / self.transfers if self.transfers else 1.0


class CompletionQueue:
    """Per-context FIFO of deferred ops with epoch-scoped write combining."""

    def __init__(self):
        self.ops: List[PendingOp] = []
        self.epoch: int = 0
        self._seq: int = 0
        self.stats = FlushStats()
        # one record per pending op that could not complete because its
        # peer died: quiet() completes instead of wedging, and the caller
        # reads the errors
        self.errors: List[dict] = []

    def submit(self, kind: str, op: str, ptr: SymPtr, pe: int, tier: str, *,
               src_pe: int = -1, work_items: int = 1, value=None, apply=None,
               delta=None, marker=None) -> PendingOp:
        rec = PendingOp(kind=kind, op=op, ptr=ptr, pe=int(pe), tier=tier,
                        epoch=self.epoch, seq=self._seq, src_pe=int(src_pe),
                        work_items=work_items, value=value, apply=apply,
                        delta=delta, marker=marker)
        self._seq += 1
        self.ops.append(rec)
        self.stats.submitted += 1
        return rec

    def fence(self) -> None:
        """Close the current epoch."""
        if any(o.epoch == self.epoch for o in self.ops):
            self.epoch += 1

    def supersede(self, ptr: SymPtr, pe: int) -> int:
        """Drop pending puts that a blocking store to (ptr, pe) fully
        covers.  Returns the number dropped."""
        pe = int(pe)
        lo, hi = ptr.offset, ptr.offset + ptr.size
        keep, dropped = [], 0
        for o in self.ops:
            if (o.kind == PUT and o.pe == pe and o.ptr.dtype == ptr.dtype
                    and lo <= o.ptr.offset and o.end <= hi):
                _retag_marker(o, "dropped")
                dropped += 1
            else:
                keep.append(o)
        self.ops = keep
        return dropped

    def resolve_store_conflicts(self, ctx, heap, ptr: SymPtr, pe: int, *,
                                covers: bool = True):
        """Linearise a blocking store to (ptr, pe) as program order: fully
        covered pending puts are dropped, partial overlaps complete first.
        ``covers=False`` drops nothing.  Returns the (possibly flushed)
        heap."""
        pe = int(pe)
        lo, hi = ptr.offset, ptr.offset + max(1, ptr.size)
        last_flush = None
        for i, o in enumerate(self.ops):
            if (o.pe == pe and o.ptr.dtype == ptr.dtype
                    and o.ptr.offset < hi and lo < o.end
                    and not (covers and o.kind == PUT
                             and lo <= o.ptr.offset and o.end <= hi)):
                last_flush = i
        if last_flush is not None:
            heap = self.flush_prefix(ctx, heap, last_flush)
        if covers:
            self.supersede(ptr, pe)
        return heap

    def __len__(self) -> int:
        return len(self.ops)

    def pending_for(self, ptr: SymPtr, pe: int) -> Optional[int]:
        """Index of the LAST pending op overlapping (ptr, pe)."""
        pe = int(pe)
        last = None
        for i, o in enumerate(self.ops):
            if (o.pe == pe and o.ptr.dtype == ptr.dtype
                    and o.ptr.offset < ptr.offset + max(1, ptr.size)
                    and ptr.offset < o.end):
                last = i
        return last

    def pending_first(self, ptr: SymPtr, pe: int) -> Optional[int]:
        """Index of the FIRST pending op overlapping (ptr, pe): the minimal
        prefix a device-side wait needs to advance the word."""
        pe = int(pe)
        for i, o in enumerate(self.ops):
            if (o.pe == pe and o.ptr.dtype == ptr.dtype
                    and o.ptr.offset < ptr.offset + max(1, ptr.size)
                    and ptr.offset < o.end):
                return i
        return None

    # ------------------------------------------------------ fault handling
    @staticmethod
    def _dead_pes(ctx):
        return ctx.fault.dead_pes

    @staticmethod
    def _touches(op: PendingOp, pes) -> bool:
        return op.pe in pes or op.src_pe in pes

    def cancel_pe(self, ctx, pe: int) -> int:
        """Cancel with an error every queued op touching ``pe`` as source
        or destination (the peer died: nothing may land on or be read from
        its row).  Each leaves a record on ``errors``; later flushes then
        complete instead of wedging.  Returns the number cancelled."""
        pes = {int(pe)}
        keep, dead = [], []
        for o in self.ops:
            (dead if self._touches(o, pes) else keep).append(o)
        self.ops = keep
        for o in dead:
            self._cancel(ctx, o, f"pe {int(pe)} died")
        return len(dead)

    def _cancel(self, ctx, op: PendingOp, reason: str) -> None:
        self.errors.append({
            "op": op.op, "kind": op.kind, "pe": op.pe, "src_pe": op.src_pe,
            "tier": op.tier, "dtype": op.ptr.dtype, "offset": op.ptr.offset,
            "nbytes": op.ptr.nbytes, "reason": reason,
        })
        self.stats.cancelled += 1
        _retag_marker(op, "cancelled")
        if ctx.tracer.enabled:
            ctx.tracer.instant("op_cancelled", "cq", "core", "cq",
                               op=op.op, pe=op.pe, reason=reason)

    def _partition_limit(self, ctx, ops) -> Optional[int]:
        """Index of the first dcn-tier op of ``ops`` while the proxy ring
        is partitioned: nothing at or past it may complete.  None when the
        ring is healthy."""
        if not ctx.fault.dcn_down:
            return None
        for i, o in enumerate(ops):
            if o.tier == "dcn":
                return i
        return None

    # -------------------------------------------------------------- flush
    def flush(self, ctx, heap, *, proxy=None):
        """Complete every pending op, in order.  Returns the heap.
        While the proxy ring is partitioned only the prefix before the
        first cross-pod op completes; the rest waits for the heal."""
        limit = self._partition_limit(ctx, self.ops)
        if limit is None:
            limit = len(self.ops)
        return self._flush_ops(ctx, heap, self.ops[:limit], proxy=proxy,
                               keep_from=limit)

    def flush_prefix(self, ctx, heap, upto: int, *, proxy=None):
        """Complete ops[0..upto] (inclusive), keep the rest pending
        (clamped below a partition)."""
        limit = self._partition_limit(ctx, self.ops[:upto + 1])
        if limit is not None:
            upto = limit - 1
        return self._flush_ops(ctx, heap, self.ops[:upto + 1], proxy=proxy,
                               keep_from=upto + 1)

    def flush_dependency(self, ctx, heap, ptr: SymPtr, pe: int, *,
                         proxy=None):
        """Complete the queue prefix the word at (ptr, pe) depends on; a
        no-op when nothing pending targets it."""
        dep = self.pending_for(ptr, pe)
        if dep is not None:
            heap = self.flush_prefix(ctx, heap, dep, proxy=proxy)
        return heap

    def _flush_ops(self, ctx, heap, ops, *, proxy, keep_from):
        if not ops:
            return heap
        remainder = self.ops[keep_from:]
        dead = self._dead_pes(ctx)
        if dead:
            live = []
            for o in ops:
                if self._touches(o, dead):
                    self._cancel(ctx, o, "peer died with op in flight")
                else:
                    live.append(o)
            ops = live
            if not ops:
                self.ops = remainder
                return heap
        transfers = (_combine(ops) if ctx.tuning.nbi_coalesce
                     else [[o] for o in ops])
        tracer = ctx.tracer
        if tracer.enabled:
            tracer.begin("flush", "cq", "core", "cq",
                         ops=len(ops), transfers=len(transfers))
        undrained = False
        for group in transfers:
            if undrained and not self._routes_to_proxy(group, proxy):
                # a directly applied op must observe every ring message
                # submitted before it: drain before leaving the proxy run
                heap = proxy.drain(heap)
                undrained = False
            heap, used_proxy = self._issue(ctx, heap, group, proxy)
            undrained = undrained or used_proxy
        if undrained:
            heap = proxy.drain(heap)
        self.stats.flushed_ops += len(ops)
        self.stats.flushed_bytes += sum(o.ptr.nbytes for o in ops)
        self.stats.transfers += len(transfers)
        self.stats.transfer_bytes += sum(_group_nbytes(g) for g in transfers)
        self.stats.flushes += 1
        self.ops = remainder
        for o in ops:
            _retag_marker(o, "done")
        if tracer.enabled:
            tracer.end("flush", "cq", "core", "cq",
                       bytes=sum(_group_nbytes(g) for g in transfers))
            tracer.counter("cq_pending", "core", "cq", pending=len(remainder))
        return heap

    @staticmethod
    def _routes_to_proxy(group, proxy) -> bool:
        return (proxy is not None and group[0].kind == PUT
                and group[0].tier == "dcn")

    @staticmethod
    def _issue(ctx, heap, group, proxy):
        """One coalesced transfer, one (merged) atomic, one signal update or
        one fetch.  Returns ``(heap, went_through_the_ring)``."""
        head = group[0]
        if head.kind == GET:
            # the fetch completed at submission; its cost accrues here
            path = "proxy" if head.tier == "dcn" else "engine"
            ctx.record(head.op, head.ptr.nbytes, path, head.tier,
                       head.work_items)
            return heap, False
        if head.kind in (AMO, SIGNAL):
            new = heap.read(head.ptr, head.pe).reshape(())
            for o in group:                   # merged adds compose in order
                new = o.apply(new)
            path = "proxy" if head.tier == "dcn" else "direct"
            ctx.record(head.op, TORCH_DTYPES[head.ptr.dtype].itemsize, path,
                       head.tier, head.work_items)
            return heap.write(head.ptr, head.pe, new), False
        ptr, value = _merge_puts(group)
        if len(group) > 1:                    # the run's merged payload
            heap.tally.copy_bytes += value.numel() * value.element_size()
        tracer = ctx.tracer
        if head.tier == "dcn" and proxy is not None:
            if proxy.ring_full():
                # a migration storm filled the ring: the producer must wait
                # for the consumer, and we hold the heap, so the proxy
                # thread catches up here (backpressure, not message loss)
                heap = proxy.drain(heap)
                proxy.backpressure += 1
                if tracer.enabled:
                    tracer.instant("ring_backpressure", "cq", "core", "cq",
                                   pe=head.pe)
            proxy.put(ptr, value, head.pe)    # ring message; drained once
            if tracer.enabled:
                tracer.instant("xfer", "cq", "core", "cq", path="proxy",
                               tier="dcn", nbytes=ptr.nbytes, pe=head.pe,
                               coalesced=len(group))
            return heap, True
        wi = max(o.work_items for o in group)
        if head.tier == "dcn":
            path = "proxy"
        else:
            path = cutover.choose_path(ptr.nbytes, work_items=wi,
                                       tier=head.tier, hw=ctx.hw,
                                       tuning=ctx.tuning)
        ctx.record(head.op, ptr.nbytes, path, head.tier, wi)
        if tracer.enabled:
            tracer.instant("xfer", "cq", "core", "cq", path=path,
                           tier=head.tier, nbytes=ptr.nbytes, pe=head.pe,
                           work_items=wi, coalesced=len(group))
        return heap.write(ptr, head.pe, value), False


# ---------------------------------------------------------------------------
# write combining
# ---------------------------------------------------------------------------


def _combinable(a: PendingOp, b: PendingOp) -> bool:
    """b may join a's transfer: queue-adjacent puts, same destination row
    and epoch, byte ranges that abut or coincide."""
    return (a.kind == PUT and b.kind == PUT
            and a.pe == b.pe and a.epoch == b.epoch
            and a.ptr.dtype == b.ptr.dtype
            and (b.ptr.offset == a.end
                 or (b.ptr.offset == a.ptr.offset
                     and b.ptr.size == a.ptr.size)))


def _amo_mergeable(a: PendingOp, b: PendingOp) -> bool:
    return (a.kind == AMO and b.kind == AMO
            and a.delta is not None and b.delta is not None
            and a.pe == b.pe and a.epoch == b.epoch and a.ptr == b.ptr)


def _combine(ops: List[PendingOp]) -> List[List[PendingOp]]:
    groups: List[List[PendingOp]] = []
    for o in ops:
        if groups and (_combinable(groups[-1][-1], o)
                       or _amo_mergeable(groups[-1][-1], o)):
            groups[-1].append(o)
        else:
            groups.append([o])
    return groups


def _merge_puts(group: List[PendingOp]):
    """Fold a combinable run into one (ptr, flat_value) transfer; later
    puts win where ranges coincide."""
    head = group[0]
    if len(group) == 1:
        return head.ptr, head.value
    lo = min(o.ptr.offset for o in group)
    hi = max(o.end for o in group)
    buf = head.value.new_zeros(hi - lo)
    for o in group:
        s = o.ptr.offset - lo
        buf[s:s + o.ptr.size] = o.value
    return SymPtr(head.ptr.dtype, lo, (hi - lo,)), buf


def _group_nbytes(group: List[PendingOp]) -> int:
    head = group[0]
    if head.kind != PUT:
        return head.ptr.nbytes
    lo = min(o.ptr.offset for o in group)
    hi = max(o.end for o in group)
    return (hi - lo) * TORCH_DTYPES[head.ptr.dtype].itemsize


def _retag_marker(op: PendingOp, state: str) -> None:
    """Retag the op's own "(pending)" trace marker."""
    rec = op.marker
    if rec is not None and rec.op.endswith("(pending)"):
        rec.op = rec.op[: -len("(pending)")] + f"({state})"
