"""K9 — the vectorised tile reduction (``csrc/reduce_tile.cu``).

Replaces ``repro/kernels/reduce_tile.py::reduce_tile``: ``(T, N) -> (N,)``
by sum, max, min or prod over the T rows, N a multiple of 128.  Every input
type is widened to f32 and the rows fold in order, then the result is cast
back, as the TPU kernel does (so int32 goes through f32 too, unlike the
reference's oracle in ``kernels/ref.py``).  Bound by bytes.  Only the
reference's benchmark and tests call it; the port reaches it through
``ops.reduce_tile``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.roofline import counter

LANE = 128
OPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
       "prod": torch.mul}
_OP_CODE = {"sum": 0, "max": 1, "min": 2, "prod": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def reduce_tile_plain(rows: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Plain version of K9: fold the rows in order in f32, then cast back
    to the rows' dtype."""
    fn = OPS[op]
    acc = rows[0].float()
    for i in range(1, rows.shape[0]):
        acc = fn(acc, rows[i].float())
    return acc.to(rows.dtype)


def reduce_tile(rows: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``(T, N) -> (N,)`` by ``op`` over the rows."""
    if rows.dim() != 2 or rows.shape[0] < 1 or rows.shape[1] % LANE:
        raise ValueError(f"reduce_tile: rows {tuple(rows.shape)} must be "
                         f"(T >= 1, N) with N a multiple of {LANE}")
    if op not in _OP_CODE:
        raise ValueError(f"reduce_tile: op {op!r} not in {tuple(_OP_CODE)}")
    if rows.dtype not in _DTYPE_CODE:
        raise TypeError(f"reduce_tile: dtype {rows.dtype}; takes one of "
                        f"{tuple(_DTYPE_CODE)}")
    T, N = rows.shape
    with counter.charge("reduce_tile", lambda: counter.reduce_tile_work(
            T, N, rows.element_size())):
        where = ops.route(rows)
        if where == "cpu":
            return reduce_tile_plain(rows, op)
        out = torch.empty(N, dtype=rows.dtype, device=rows.device)
        if where == "cuda":
            if not rows.is_contiguous():
                raise ValueError("reduce_tile: rows must be contiguous")
            ops.launch("reduce_tile", "ishmem_reduce_tile",
                       rows.get_device(), rows.data_ptr(), out.data_ptr(),
                       T, N, _DTYPE_CODE[rows.dtype], _OP_CODE[op])
        return out
