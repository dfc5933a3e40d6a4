"""Signaling ops: put_signal, put_signal_nbi, signal_fetch and
signal_wait_until.

Counterpart of ``repro/core/signal.py``.  ``put_signal`` completes the data
put before the flag update.  ``put_signal_nbi`` defers both
halves onto the completion queue as an ordered pair: the data put, then a
non-coalescible signal update, so write combining never lifts a later put
across the flag.  ``signal_wait_until`` is the completion point that makes
the pair observable.  Reading the signal back to the host synchronises with
the device on every poll.
"""
from __future__ import annotations

import torch

from repro_torch.core import pending as pending_mod, rma
from repro_torch.core.heap import TORCH_DTYPES

SIGNAL_SET = 0
SIGNAL_ADD = 1

_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


def _sig_apply(signal, sig_op):
    def apply(old):
        sv = torch.tensor(signal, dtype=old.dtype, device=old.device)
        return sv if sig_op == SIGNAL_SET else old + sv
    return apply


def put_signal(ctx, heap, dest, value, sig_ptr, signal, sig_op, dst_pe, *,
               src_pe: int = 0, work_items: int = 1):
    """ishmem_put_signal / ishmemx_put_signal_work_group: blocking data put,
    then the flag update, linearised after queued ops on the flag word."""
    heap = rma.put(ctx, heap, dest, value, dst_pe, src_pe=src_pe,
                   work_items=work_items)
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, sig_ptr, dst_pe,
                                               covers=False)
    new = _sig_apply(signal, sig_op)(heap.read(sig_ptr, dst_pe).reshape(()))
    ctx.record("signal", TORCH_DTYPES[sig_ptr.dtype].itemsize, "direct",
               ctx.tier(src_pe, dst_pe), 1)
    return heap.write(sig_ptr, dst_pe, new)


def put_signal_nbi(ctx, heap, dest, value, sig_ptr, signal, sig_op, dst_pe, *,
                   src_pe: int = 0, work_items: int = 1):
    """ishmem_put_signal_nbi: deferred data put + deferred signal update,
    data before flag inside the flush."""
    heap = rma.put_nbi(ctx, heap, dest, value, dst_pe, src_pe=src_pe,
                       work_items=work_items)
    tier = ctx.tier(src_pe, dst_pe)
    ctx.record("signal(pending)", TORCH_DTYPES[sig_ptr.dtype].itemsize,
               "direct", tier, 1, t_sec=0.0)
    ctx.pending.submit(pending_mod.SIGNAL, "signal", sig_ptr, dst_pe, tier,
                       src_pe=src_pe, apply=_sig_apply(signal, sig_op),
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap


def signal_fetch(ctx, heap, sig_ptr, pe):
    """ishmem_signal_fetch: the signal word's current value."""
    return heap.read(sig_ptr, pe).reshape(()).clone()


def signal_wait_until(ctx, heap, sig_ptr, pe, cmp: str, value):
    """Local wait; in the sequential simulation a satisfiability check.
    Every pending op the waited word depends on (its last queued update and
    everything before it, which covers the data half of a put_signal_nbi) is
    flushed first.  Returns ``(heap, value, satisfied)``."""
    heap = ctx.pending.flush_dependency(ctx, heap, sig_ptr, pe)
    cur = heap.read(sig_ptr, pe).reshape(()).clone()
    ok = bool(_CMP[cmp](cur.item(), value))
    ctx.record("signal_wait", 0, "direct", "local", 1)
    return heap, cur, ok
