"""Remote Memory Access: put/get, the scalars p/g, strided iput/iget, the
nbi put/get, quiet and fence.

Counterpart of ``repro/core/rma.py``.  Semantics are one-sided: ``put``
stores into the destination PE's row of the symmetric heap, ``get`` loads
from the source PE's row.  Every op picks a transport through the cutover
engine and records it on the context's telemetry; every store lands through
the K1 copy kernel on a CUDA heap (``SymmetricHeap.write``).  ``put_nbi``
and ``get_nbi`` go through the context's completion queue.
"""
from __future__ import annotations

import torch

from repro_torch.core import cutover, pending as pending_mod
from repro_torch.core.heap import TORCH_DTYPES, SymPtr, SymmetricHeap


def _pick(ctx, nbytes, work_items, tier):
    return cutover.choose_path(nbytes, work_items=work_items, tier=tier,
                               hw=ctx.hw, tuning=ctx.tuning)


def put(ctx, heap: SymmetricHeap, dest: SymPtr, value, dst_pe, *,
        src_pe: int = 0, work_items: int = 1) -> SymmetricHeap:
    """ishmem_put (work_items=1) / ishmemx_put_work_group (work_items>1)."""
    tier = ctx.tier(src_pe, dst_pe)
    path = _pick(ctx, dest.nbytes, work_items, tier)
    ctx.record("put", dest.nbytes, path, tier, work_items)
    # a blocking store races pending nbi ops on the same bytes; the
    # simulation linearises it as program order (it lands last)
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, dest, dst_pe)
    return heap.write(dest, dst_pe, value)


def get(ctx, heap: SymmetricHeap, src: SymPtr, src_pe_remote, *,
        src_pe: int = 0, work_items: int = 1):
    """ishmem_get / ishmemx_get_work_group: one-sided load."""
    tier = ctx.tier(src_pe, src_pe_remote)
    path = _pick(ctx, src.nbytes, work_items, tier)
    ctx.record("get", src.nbytes, path, tier, work_items)
    return heap.read(src, src_pe_remote)


def p(ctx, heap, dest: SymPtr, scalar, dst_pe, *, src_pe: int = 0):
    """ishmem_p: blocking scalar store — always the direct path."""
    tier = ctx.tier(src_pe, dst_pe)
    path = "proxy" if tier == "dcn" else "direct"
    ctx.record("p", TORCH_DTYPES[dest.dtype].itemsize, path, tier, 1)
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, dest, dst_pe)
    return heap.write(dest, dst_pe, scalar)


def g(ctx, heap, src: SymPtr, src_pe_remote, *, src_pe: int = 0):
    """ishmem_g: blocking scalar fetch."""
    tier = ctx.tier(src_pe, src_pe_remote)
    path = "proxy" if tier == "dcn" else "direct"
    ctx.record("g", TORCH_DTYPES[src.dtype].itemsize, path, tier, 1)
    return heap.read(src, src_pe_remote).reshape(())


def iput(ctx, heap, dest: SymPtr, value, dst_pe, *, dst_stride: int = 1,
         src_stride: int = 1, nelems: int = None, src_pe: int = 0):
    """ishmem_iput: strided store.  Every target index must lie inside
    ``dest`` (the reference drops out-of-range stores silently; the port
    raises)."""
    value = torch.as_tensor(value, dtype=TORCH_DTYPES[dest.dtype],
                            device=heap.device).reshape(-1)
    n = nelems if nelems is not None else \
        (value.numel() + src_stride - 1) // src_stride
    picked = value[::src_stride][:n]
    if n and (n - 1) * dst_stride >= dest.size:
        raise IndexError(f"iput: {n} elements at stride {dst_stride} "
                         f"overrun a buffer of {dest.size}")
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, dest, dst_pe,
                                               covers=False)
    newv = heap.read(dest, dst_pe).reshape(-1).clone()
    newv[torch.arange(n, device=heap.device) * dst_stride] = picked
    nbytes = int(n) * TORCH_DTYPES[dest.dtype].itemsize
    tier = ctx.tier(src_pe, dst_pe)
    ctx.record("iput", nbytes, _pick(ctx, nbytes, 1, tier), tier, 1)
    return heap.write(dest, dst_pe, newv)


def iget(ctx, heap, src: SymPtr, src_pe_remote, *, src_stride: int = 1,
         nelems: int = None, src_pe: int = 0):
    """ishmem_iget: strided load."""
    data = heap.read(src, src_pe_remote).reshape(-1)
    n = nelems if nelems is not None else data.numel() // max(1, src_stride)
    out = data[::src_stride][:n]
    nbytes = int(n) * TORCH_DTYPES[src.dtype].itemsize
    tier = ctx.tier(src_pe, src_pe_remote)
    ctx.record("iget", nbytes, _pick(ctx, nbytes, 1, tier), tier, 1)
    return out


def put_nbi(ctx, heap, dest, value, dst_pe, *, src_pe: int = 0,
            work_items: int = 1):
    """ishmem_put_nbi: the destination row is NOT written here; the op is
    deferred onto the completion queue and lands at the next completion
    point.  The queue owns a copy of the payload, so no view keeps an older
    (possibly multi-gigabyte) pool tensor alive while the op is pending."""
    value = heap.coerce(dest, value).clone()
    tier = ctx.tier(src_pe, dst_pe)
    path = "proxy" if tier == "dcn" else "engine"
    # trace marker only (t=0): the completed transfer is priced at flush
    ctx.record("put_nbi(pending)", dest.nbytes, path, tier, work_items,
               t_sec=0.0)
    ctx.pending.submit(pending_mod.PUT, "put_nbi", dest, dst_pe, tier,
                       src_pe=src_pe, work_items=work_items, value=value,
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap


def get_nbi(ctx, heap, src, src_pe_remote, *, src_pe: int = 0,
            work_items: int = 1):
    """ishmem_get_nbi: the buffer is undefined until ``quiet``; the fetch
    is linearised at submission (any point up to quiet is legal), and its
    cost is recorded when the queue flushes."""
    tier = ctx.tier(src_pe, src_pe_remote)
    path = "proxy" if tier == "dcn" else "engine"
    ctx.record("get_nbi(pending)", src.nbytes, path, tier, work_items,
               t_sec=0.0)
    ctx.pending.submit(pending_mod.GET, "get_nbi", src, src_pe_remote, tier,
                       src_pe=src_pe, work_items=work_items,
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap.read(src, src_pe_remote)


def quiet(ctx, heap, *, proxy=None):
    """ishmem_quiet: completes every pending nbi op; with a ``proxy``,
    dcn-tier puts travel its ring and drain."""
    heap = ctx.pending.flush(ctx, heap, proxy=proxy)
    ctx.record("quiet", 0, "direct", "local", 1)
    return heap


def fence(ctx, heap):
    """ishmem_fence: orders (but does not complete) pending ops."""
    ctx.pending.fence()
    ctx.record("fence", 0, "direct", "local", 1)
    return heap
