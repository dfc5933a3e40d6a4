"""Launch plumbing shared by the port's kernel wrappers, K9's entry point
and the ring allreduces built from the kernels
(``repro/kernels/ops.py:41-43, 77-111``).

Each wrapper (``rma_copy.copy_into`` and ``remote_put``,
``flash_attn.flash_attention``, ``ishmem_device.paged_gather``,
``paged_flash_attention``, ``flash_partial_split`` and ``flash_partial``,
``ring_collectives``' four, ``reduce_tile.reduce_tile`` and
``decode_attn.decode_attention``) checks its
inputs, allocates its outputs
and calls :func:`launch`, which runs the C entry point (bound once, when the
library loads, in ``_build.ENTRIES``) on the tensor's device and current
stream, raises on a nonzero ``cudaError_t`` (a launch the card
refuses never runs, and no later synchronise reports it), and counts the
launch.  A wrapper given CPU tensors runs its plain PyTorch version instead
and counts nothing; given ``meta`` tensors (the dry-run) it returns empty
outputs of the kernel's shapes on ``meta`` and runs neither.  On every
route it charges the open work counters its kernel's formula
(``roofline/counter.py``).

``LAUNCHES`` is the per-kernel count a run reads to show its main path went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"copy_into": 0, "flash_attention": 0, "paged_gather": 0,
            "remote_put": 0, "ring_allgather": 0, "ring_reduce_scatter": 0,
            "push_broadcast": 0, "barrier_push": 0, "reduce_tile": 0,
            "flash_partial_split": 0, "flash_partial": 0,
            "fused_paged_attn": 0, "decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(name: str, entry: str, device: int, *args) -> None:
    """Run C entry point ``entry`` of ``_build.ENTRIES`` on CUDA device
    ``device`` (an ordinal, as ``Tensor.get_device()`` gives it) and its
    current stream, raise on a nonzero ``cudaError_t``, and count the
    launch under ``name``."""
    # the current stream's handle, as torch.cuda.current_stream(device)
    # .cuda_stream gives it, without building a Stream object each launch
    stream = torch._C._cuda_getCurrentRawStream(device)
    rc = _build.entries()[entry](device, *args, stream)
    if rc:
        msg = _build.lib().ishmem_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def route(*tensors) -> str:
    """Where a wrapper's tensors send it: ``"cuda"`` when every one lies
    on one CUDA device (the kernel), ``"cpu"`` when every one lies on the
    CPU (the plain version), ``"meta"`` when every one is a meta tensor
    (empty outputs, the dry-run); raises otherwise.  The CUDA case reads
    no ``torch.device``: it is every launch's test."""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        for t in tensors[1:]:
            if not (t.is_cuda and t.get_device() == index):
                break
        else:
            return "cuda"
    elif all(t.is_cpu for t in tensors):
        return "cpu"
    elif all(t.is_meta for t in tensors):
        return "meta"
    raise ValueError(f"tensors on mixed or unsupported devices: "
                     f"{[str(t.device) for t in tensors]}")


def reduce_tile(rows: torch.Tensor, op: str = "sum",
                block: int = 512) -> torch.Tensor:
    """K9: ``(T, N) -> (N,)`` by ``op`` over the rows, f32 accumulation
    (``repro/kernels/ops.py::reduce_tile``).  ``block`` is the reference's
    tile width; it changes neither the result nor the launch."""
    del block
    from repro_torch.kernels import reduce_tile as rt_mod
    return rt_mod.reduce_tile(rows, op)


# ---------------------------------------------------------------------------
# ring allreduces over PE-stacked tensors (leading axis = PE)
# ---------------------------------------------------------------------------


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Allreduce = ring reduce-scatter (K6) + ring all-gather (K5).
    ``x``: ``(npes, npes, chunk...)`` addend rows per PE; returns
    ``(npes, npes, chunk...)``, every PE holding every reduced chunk."""
    from repro_torch.kernels import ring_collectives
    mine = ring_collectives.ring_reduce_scatter(x)
    return ring_collectives.ring_allgather(mine)


def ring_step_nbi(x: torch.Tensor, *, work_items: int = 8) -> torch.Tensor:
    """One ring step: every PE puts its buffer to its right neighbour (K4)
    and gets the one from its left."""
    from repro_torch.kernels import rma_copy
    return rma_copy.remote_put(x, target_offset=1, work_items=work_items)


def ring_allreduce_nbi(x: torch.Tensor, *, work_items: int = 8) -> torch.Tensor:
    """Pass-around allreduce: each step's transfer feeds only the next
    transfer, so the adds stay off the transfer chain.  Moves npes * n bytes
    per PE (RS+AG moves 2n), so callers keep it to small messages."""
    acc = x
    cur = x
    for _ in range(x.shape[0] - 1):
        cur = ring_step_nbi(cur, work_items=work_items)
        acc = acc + cur
    return acc
