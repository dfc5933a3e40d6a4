"""Weights and optimizer state across: a nested dict of numpy arrays -> the
port's tensors.

The input is typically the JAX package's ``init_params`` output passed
through ``np.asarray`` leaf by leaf.  Every array is copied (JAX's numpy
views are read-only); a ``bfloat16`` array (``dtype.name == "bfloat16"``,
the ``ml_dtypes`` type) goes through a uint16 view, since ``torch.from_numpy``
does not take that type.  Stacked ``blocks`` keep their leading repeat axis.
Neither jax nor ml_dtypes is imported here.  The optimizer state
(AdamW's ``step``, ``m`` and ``v``; Adafactor's ``step`` and its ``v``
tree of ``vr``/``vc`` or ``v``) crosses with :func:`opt_state_to_torch`.
"""
from __future__ import annotations

import numpy as np
import torch


def array_to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def to_torch(tree, device):
    """Map every array leaf of a dict/list tree onto ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return array_to_torch(tree, device)


def opt_state_to_torch(state, device):
    """The reference's optimizer state as the port keeps it: the moments on
    ``device``, the step counter a 0-d int32 CPU tensor
    (``train/optimizer.py``)."""
    out = {k: to_torch(v, device) for k, v in state.items() if k != "step"}
    out["step"] = array_to_torch(state["step"], "cpu").to(torch.int32)
    return out
