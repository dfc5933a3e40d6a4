"""K3 — the block-table gather of paged decode (``csrc/ishmem_device.cu``).

Replaces ``repro/kernels/ishmem_device.py::_paged_gather_pallas`` and its
wrapper ``paged_gather``, which ``PagedDecodeView.assemble`` did not call
(it gathered with ``data[table]``); the port's ``assemble`` does.  The
reference's probe-and-fallback has no counterpart.  Bound by bytes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

MAX_ROWS = 65535            # table entries map to gridDim.y


def paged_gather_plain(data: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``out[b, j] = data[table[b, j]]``, where an
    entry equal to ``data.shape[0]`` reads a row of zeros."""
    out = data.new_zeros((*table.shape, data.shape[1]))
    mapped = table < data.shape[0]
    out[mapped] = data[table[mapped].long()]
    return out


def paged_gather(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather block payload rows through a block table.

    ``data``: ``(num_rows, block_words)``, any dtype; ``table``:
    ``(num_slots, nb)`` int32 with entries in ``[0, num_rows]``, where
    ``num_rows`` marks an unmapped slot that reads zeros.  Returns
    ``(num_slots, nb, block_words)``, bitwise what ``data[table]`` gives
    over ``data`` with a zero row appended."""
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("paged_gather: data must be a contiguous 2-D array")
    if table.dim() != 2 or table.dtype != torch.int32:
        raise TypeError("paged_gather: table must be a 2-D int32 array")
    R = data.shape[0]
    if table.numel() and (int(table.min()) < 0 or int(table.max()) > R):
        raise IndexError(f"paged_gather: table entries outside [0, {R}]")
    if ops.on_cpu(data, table):
        return paged_gather_plain(data, table)
    if table.numel() > MAX_ROWS:
        raise ValueError(f"paged_gather: {table.numel()} entries exceed "
                         f"{MAX_ROWS}")
    table = table.contiguous()
    out = torch.empty((*table.shape, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    ops.launch("paged_gather", "ishmem_paged_gather", data.device,
               out.data_ptr(), data.data_ptr(), table.data_ptr(),
               table.numel(), data.shape[1] * data.element_size(), R)
    return out
