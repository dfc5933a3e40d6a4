"""K1 — the work-group heap store (``csrc/rma_copy.cu``).

Replaces ``repro/kernels/rma_copy.py::wg_copy_local`` and its wrapper
``repro/kernels/ops.py::copy_into``.  The kernel takes any length and any
offset, so the reference's ``.at[].set`` branch for unaligned transfers has
no counterpart.  It is bound by bytes (2 n itemsize over the memory rate);
see the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def copy_into_plain(dst_row: torch.Tensor, src: torch.Tensor,
                    offset: int) -> torch.Tensor:
    """Plain version of K1: ``dst_row[offset:offset+n] = src``, in place."""
    dst_row[offset:offset + src.numel()] = src.reshape(-1)
    return dst_row


def copy_into(dst_row: torch.Tensor, src: torch.Tensor,
              offset: int) -> torch.Tensor:
    """Store ``src`` (flattened) into ``dst_row`` at element ``offset``, in
    place, and return ``dst_row``.  The caller owns ``dst_row``: the
    functional heap passes a freshly cloned pool row, so no snapshot sees
    the store."""
    n = src.numel()
    if dst_row.dim() != 1 or not dst_row.is_contiguous():
        raise ValueError("copy_into: dst_row must be a contiguous 1-D row")
    if not src.is_contiguous():
        raise ValueError("copy_into: src must be contiguous")
    if src.dtype != dst_row.dtype or dst_row.dtype not in DTYPES:
        raise TypeError(f"copy_into: {src.dtype} into {dst_row.dtype}; "
                        f"takes one of {DTYPES}")
    if not 0 <= offset <= dst_row.numel() - n:
        raise IndexError(f"copy_into: [{offset}, {offset + n}) outside a row "
                         f"of {dst_row.numel()}")
    if ops.on_cpu(dst_row, src):
        return copy_into_plain(dst_row, src, offset)
    ops.launch("copy_into", "ishmem_copy_into", dst_row.device,
               dst_row.data_ptr(), src.data_ptr(), n, offset,
               dst_row.element_size())
    return dst_row
