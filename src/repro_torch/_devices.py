"""Where the port's entry points run: on the card unless the caller asks."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is
    none: the port never falls back to the CPU on its own.  Tests and
    CPU runs pass ``device="cpu"``, which runs every kernel's plain
    version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current device, as tensors made there record it
        return torch.device("cuda", torch.cuda.current_device())
    return dev
