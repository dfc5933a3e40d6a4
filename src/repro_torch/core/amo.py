"""Atomic Memory Operations on symmetric scalars (OpenSHMEM 1.5 AMO set).

Counterpart of ``repro/core/amo.py``.  Each AMO is a linearisable
read-modify-write of one element of the symmetric heap: a blocking AMO
first completes every queued op on that element, then stores through the
heap (K1 on a CUDA heap, in place) and returns the pre-image, an owned
copy that a later store leaves as it was.  Non-fetching nbi AMOs
queue on the completion queue, where adjacent adds to one element merge.
Bitwise AMOs take the heap's int32 pool (the port keeps no unsigned pool).
"""
from __future__ import annotations

import torch

from repro_torch.core import pending as pending_mod
from repro_torch.core.heap import TORCH_DTYPES, SymPtr


def _as(value, old: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=old.dtype, device=old.device)


def _rmw(ctx, heap, ptr: SymPtr, pe, fn, opname, src_pe=0):
    # a blocking atomic linearises after everything queued on this element
    # (it reads, so nothing may be dropped)
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, ptr, pe,
                                               covers=False)
    old = heap.read(ptr, pe).reshape(()).clone()
    new = fn(old)
    tier = ctx.tier(src_pe, pe)
    path = "proxy" if tier == "dcn" else "direct"
    ctx.record(f"amo_{opname}", TORCH_DTYPES[ptr.dtype].itemsize, path, tier,
               1)
    return heap.write(ptr, pe, new), old


def _rmw_nbi(ctx, heap, ptr: SymPtr, pe, fn, opname, src_pe=0, delta=None):
    """Deferred (non-fetching) AMO: queued, run at the next completion
    point.  Fetching AMOs cannot defer: their result is the pre-image."""
    tier = ctx.tier(src_pe, pe)
    ctx.record(f"amo_{opname}(pending)", TORCH_DTYPES[ptr.dtype].itemsize,
               "proxy" if tier == "dcn" else "direct", tier, 1, t_sec=0.0)
    ctx.pending.submit(pending_mod.AMO, f"amo_{opname}", ptr, pe, tier,
                       apply=fn, delta=delta,
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap


def fetch(ctx, heap, ptr, pe, *, src_pe=0):
    _, old = _rmw(ctx, heap, ptr, pe, lambda o: o, "fetch", src_pe)
    return old


def set_(ctx, heap, ptr, value, pe, *, src_pe=0):
    heap2, _ = _rmw(ctx, heap, ptr, pe, lambda o: _as(value, o), "set",
                    src_pe)
    return heap2


def swap(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw(ctx, heap, ptr, pe, lambda o: _as(value, o), "swap", src_pe)


def compare_swap(ctx, heap, ptr, cond, value, pe, *, src_pe=0):
    def fn(old):
        return torch.where(old == _as(cond, old), _as(value, old), old)
    return _rmw(ctx, heap, ptr, pe, fn, "cswap", src_pe)


def fetch_add(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw(ctx, heap, ptr, pe, lambda o: o + _as(value, o), "fadd",
                src_pe)


def add(ctx, heap, ptr, value, pe, *, src_pe=0):
    heap2, _ = fetch_add(ctx, heap, ptr, value, pe, src_pe=src_pe)
    return heap2


def fetch_inc(ctx, heap, ptr, pe, *, src_pe=0):
    return fetch_add(ctx, heap, ptr, 1, pe, src_pe=src_pe)


def inc(ctx, heap, ptr, pe, *, src_pe=0):
    return add(ctx, heap, ptr, 1, pe, src_pe=src_pe)


# ------------------------------------------------------------------ nbi AMOs


def add_nbi(ctx, heap, ptr, value, pe, *, src_pe=0):
    """Deferred shmem_atomic_add: lands at quiet/barrier; queue-adjacent
    adds to the same element merge into one atomic."""
    return _rmw_nbi(ctx, heap, ptr, pe, lambda o: o + _as(value, o),
                    "add_nbi", src_pe, delta=value)


def inc_nbi(ctx, heap, ptr, pe, *, src_pe=0):
    return add_nbi(ctx, heap, ptr, 1, pe, src_pe=src_pe)


def set_nbi(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw_nbi(ctx, heap, ptr, pe, lambda o: _as(value, o), "set_nbi",
                    src_pe)


def fetch_and(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw(ctx, heap, ptr, pe, lambda o: o & _as(value, o), "fand",
                src_pe)


def fetch_or(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw(ctx, heap, ptr, pe, lambda o: o | _as(value, o), "for",
                src_pe)


def fetch_xor(ctx, heap, ptr, value, pe, *, src_pe=0):
    return _rmw(ctx, heap, ptr, pe, lambda o: o ^ _as(value, o), "fxor",
                src_pe)
