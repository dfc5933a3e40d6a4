"""Checkpointing (counterpart of ``repro/train/checkpoint.py``): a flat
``payload.npz`` plus ``meta.json``, published by an atomic rename, with
retention.

The layout is the reference's: arrays ``a{i}`` in JAX's leaf order, and
``meta.json`` with ``step``, ``keys`` (each leaf's ``jax.tree_util.keystr``
path, e.g. ``"[0]['blocks'][0]['attn']['wq']"``), ``dtypes`` and
``extra``.  So a checkpoint written by one package restores in the other.
A bfloat16 leaf is stored as its uint16 bits (numpy has no bfloat16; the
dtype in ``meta.json`` says ``bfloat16``), and read back through the same
view, as ``_bridge.py`` reads the ``ml_dtypes`` arrays JAX hands out.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import _bridge
from repro_torch.train import tree as tree_mod


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, extra: dict = None):
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = tree_mod.flatten(tree)
    meta = {
        "step": int(step),
        "keys": [k for k, _ in flat],
        "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in flat},
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    np.savez(os.path.join(tmp, "payload.npz"),
             **{f"a{i}": _to_numpy(v) for i, (_, v) in enumerate(flat)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like: torch.Tensor):
    if dtype == "bfloat16" and arr.dtype != np.uint16:
        arr = arr.view(np.uint16)          # the reference's raw 2-byte words
    t = _bridge.array_to_torch(arr, like.device)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.dtype)


def restore(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of ``tree_like`` (validates key paths
    and shapes); each leaf takes ``tree_like``'s dtype and device."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    payload = np.load(os.path.join(d, "payload.npz"))
    by_key = {k: (payload[f"a{i}"], meta["dtypes"][k])
              for i, k in enumerate(meta["keys"])}
    restored = []
    for k, leaf in tree_mod.flatten(tree_like):
        if k not in by_key:
            raise KeyError(f"checkpoint missing {k}")
        arr, dtype = by_key[k]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        restored.append(_from_numpy(arr, dtype, leaf))
    return tree_mod.unflatten(tree_like, restored), meta
