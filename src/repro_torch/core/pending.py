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

Not ported yet: fault cancellation and the host-proxy route (dcn-tier ops
complete on the modeled proxy path, and ``flush(proxy=...)`` raises) — they
come with the fleet slice (ROADMAP queue 1, item 10).
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

    def coalescing_ratio(self) -> float:
        return self.flushed_ops / self.transfers if self.transfers else 1.0


class CompletionQueue:
    """Per-context FIFO of deferred ops with epoch-scoped write combining."""

    def __init__(self):
        self.ops: List[PendingOp] = []
        self.epoch: int = 0
        self._seq: int = 0
        self.stats = FlushStats()

    def submit(self, kind: str, op: str, ptr: SymPtr, pe: int, tier: str, *,
               work_items: int = 1, value=None, apply=None, delta=None,
               marker=None) -> PendingOp:
        rec = PendingOp(kind=kind, op=op, ptr=ptr, pe=int(pe), tier=tier,
                        epoch=self.epoch, seq=self._seq,
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

    # -------------------------------------------------------------- flush
    def flush(self, ctx, heap, *, proxy=None):
        """Complete every pending op, in order.  Returns the new heap.  The
        host-proxy route is not ported: a ``proxy`` raises."""
        if proxy is not None:
            raise NotImplementedError(
                "flush through a HostProxy comes with the fleet slice "
                "(ROADMAP queue 1, item 10)")
        return self._flush_ops(ctx, heap, self.ops, keep_from=len(self.ops))

    def flush_prefix(self, ctx, heap, upto: int):
        """Complete ops[0..upto] (inclusive), keep the rest pending."""
        return self._flush_ops(ctx, heap, self.ops[:upto + 1],
                               keep_from=upto + 1)

    def flush_dependency(self, ctx, heap, ptr: SymPtr, pe: int):
        """Complete the queue prefix the word at (ptr, pe) depends on; a
        no-op when nothing pending targets it."""
        dep = self.pending_for(ptr, pe)
        if dep is not None:
            heap = self.flush_prefix(ctx, heap, dep)
        return heap

    def _flush_ops(self, ctx, heap, ops, *, keep_from):
        if not ops:
            return heap
        remainder = self.ops[keep_from:]
        transfers = (_combine(ops) if ctx.tuning.nbi_coalesce
                     else [[o] for o in ops])
        tracer = ctx.tracer
        if tracer.enabled:
            tracer.begin("flush", "cq", "core", "cq",
                         ops=len(ops), transfers=len(transfers))
        for group in transfers:
            heap = self._issue(ctx, heap, group)
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
    def _issue(ctx, heap, group):
        """One coalesced transfer, one (merged) atomic, one signal update or
        one fetch."""
        head = group[0]
        if head.kind == GET:
            # the fetch completed at submission; its cost accrues here
            path = "proxy" if head.tier == "dcn" else "engine"
            ctx.record(head.op, head.ptr.nbytes, path, head.tier,
                       head.work_items)
            return heap
        if head.kind in (AMO, SIGNAL):
            new = heap.read(head.ptr, head.pe).reshape(())
            for o in group:                   # merged adds compose in order
                new = o.apply(new)
            path = "proxy" if head.tier == "dcn" else "direct"
            ctx.record(head.op, TORCH_DTYPES[head.ptr.dtype].itemsize, path,
                       head.tier, head.work_items)
            return heap.write(head.ptr, head.pe, new)
        ptr, value = _merge_puts(group)
        wi = max(o.work_items for o in group)
        if head.tier == "dcn":
            path = "proxy"
        else:
            path = cutover.choose_path(ptr.nbytes, work_items=wi,
                                       tier=head.tier, hw=ctx.hw,
                                       tuning=ctx.tuning)
        ctx.record(head.op, ptr.nbytes, path, head.tier, wi)
        if ctx.tracer.enabled:
            ctx.tracer.instant("xfer", "cq", "core", "cq", path=path,
                               tier=head.tier, nbytes=ptr.nbytes, pe=head.pe,
                               work_items=wi, coalesced=len(group))
        return heap.write(ptr, head.pe, value)


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
