"""Launch plumbing shared by the port's kernel wrappers.

Each wrapper (``rma_copy.copy_into``, ``flash_attn.flash_attention``,
``ishmem_device.paged_gather``) checks its inputs, allocates its outputs and
calls :func:`launch`, which runs the C entry point on the tensor's device and
current stream, raises on a nonzero ``cudaError_t`` (a launch the card
refuses never runs, and no later synchronise reports it), and counts the
launch.  A wrapper given CPU tensors runs its plain PyTorch version instead
and counts nothing.

``LAUNCHES`` is the per-kernel count a run reads to show its main path went
through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES = {"copy_into": 0, "flash_attention": 0, "paged_gather": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    from repro_torch.kernels import _build
    lib = _build.lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, entry)(device.index, *args, stream)
    if rc:
        msg = lib.ishmem_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version route);
    False when every one lies on one CUDA device; raises otherwise."""
    kinds = {t.device for t in tensors}
    if all(d.type == "cpu" for d in kinds):
        return True
    if len(kinds) == 1 and next(iter(kinds)).type == "cuda":
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
