"""K1 — the work-group heap store (``csrc/rma_copy.cu``), and K4 — the
device-initiated remote put (``csrc/ring_collectives.cu``).

K1 replaces ``repro/kernels/rma_copy.py::wg_copy_local`` and its wrapper
``repro/kernels/ops.py::copy_into``.  The kernel takes any length and any
offset, so the reference's ``.at[].set`` branch for unaligned transfers has
no counterpart.  It is bound by bytes (2 n itemsize over the memory rate);
see the source for the design.  K4 replaces ``remote_put`` and shares the
ring collectives' flag protocol and cooperative launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.roofline import counter

DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def copy_into_plain(dst_row: torch.Tensor, src: torch.Tensor,
                    offset: int) -> torch.Tensor:
    """Plain version of K1: ``dst_row[offset:offset+n] = src``, in place."""
    dst_row[offset:offset + src.numel()] = src.reshape(-1)
    return dst_row


def copy_into(dst_row: torch.Tensor, src: torch.Tensor,
              offset: int) -> torch.Tensor:
    """Store ``src`` (flattened) into ``dst_row`` at element ``offset``, in
    place, and return ``dst_row``.  ``src`` must not overlap the bytes it is
    stored over (the body keeps four loads in flight): the heap passes its
    live pool row, and copies a source that overlaps first."""
    # every launch on the heap's store path runs these checks: each reads
    # an attribute once, the cheaper forms (ndim, itemsize) where there are
    # two, in the order that decides which error a bad call raises
    n = src.numel()
    if dst_row.ndim != 1 or not dst_row.is_contiguous():
        raise ValueError("copy_into: dst_row must be a contiguous 1-D row")
    if not src.is_contiguous():
        raise ValueError("copy_into: src must be contiguous")
    dtype = dst_row.dtype
    if src.dtype != dtype or dtype not in DTYPES:
        raise TypeError(f"copy_into: {src.dtype} into {dtype}; "
                        f"takes one of {DTYPES}")
    if not 0 <= offset <= dst_row.numel() - n:
        raise IndexError(f"copy_into: [{offset}, {offset + n}) outside a row "
                         f"of {dst_row.numel()}")
    itemsize = dst_row.itemsize
    with counter.charge("copy_into", lambda: counter.copy_work(n, itemsize)):
        where = ops.route(dst_row, src)
        if where == "cpu":
            return copy_into_plain(dst_row, src, offset)
        if where == "cuda":
            ops.launch("copy_into", "ishmem_copy_into", dst_row.get_device(),
                       dst_row.data_ptr() + int(offset) * itemsize,
                       src.data_ptr(), n * itemsize)
        return dst_row


# ---------------------------------------------------------------------------
# K4: the device-initiated remote put (csrc/ring_collectives.cu)
# ---------------------------------------------------------------------------


def remote_put_plain(x: torch.Tensor, target_offset: int = 1) -> torch.Tensor:
    """Plain version of K4: ``out[(p + target_offset) mod P] = x[p]``."""
    P = x.shape[0]
    out = torch.empty_like(x)
    for p in range(P):
        out[(p + target_offset) % P] = x[p]
    return out


def remote_put(x: torch.Tensor, *, target_offset: int = 1,
               work_items: int = 1) -> torch.Tensor:
    """Every PE puts its buffer into PE ``(p + target_offset) mod P``'s
    output.  ``x``: ``(npes, n...)`` PE-stacked.  Replaces
    ``repro/kernels/rma_copy.py::remote_put``; ``work_items`` sets the CTAs
    per PE, and every element lands (the reference leaves the last
    ``n mod w`` elements unwritten when its w slices do not divide n)."""
    from repro_torch.kernels import ring_collectives
    ring_collectives.check_stacked("remote_put", x, DTYPES)
    with counter.charge("remote_put", lambda: counter.put_work(x)):
        where = ops.route(x)
        if where == "cpu":
            return remote_put_plain(x, target_offset)
        out = torch.empty_like(x)
        if where == "cuda":
            flags = ring_collectives.flags_for(x)
            P = x.shape[0]
            ops.launch("remote_put", "ishmem_remote_put", x.get_device(),
                       out.data_ptr(), x.data_ptr(), flags.data_ptr(),
                       flags.numel(), P, x.numel() // P * x.element_size(),
                       target_offset, work_items)
        return out
