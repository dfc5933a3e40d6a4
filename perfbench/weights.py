"""Weights drawn by the benchmark from the seed, on the device, in the
type they are served in, and handed alike to the program and to the
reference.

The program's layout (key names, stacked shapes, dtypes) is read from its
``init_params`` on ``meta``, which allocates and draws nothing.  The
values are the benchmark's: one ``randn`` call per dtype into a flat
buffer, each matrix leaf a view of it scaled in place by fan_in^-0.5
(the embedding by 0.02), norms one.
"""
from __future__ import annotations

import math

import torch

ONES = ("norm1", "norm2", "final_norm", "q_norm", "k_norm")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _scale(name: str, shape) -> float:
    if name == "embed":
        return 0.02
    return (shape[0] if len(shape) <= 2 else shape[-2]) ** -0.5


def make(cfg, seed: int, device) -> dict:
    """The program's parameter tree for ``cfg``, drawn from ``seed`` on
    ``device``."""
    from repro_torch.models import model
    meta = model.init_params(cfg, device="meta")
    leaves = list(_paths(meta))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    mats = {}       # dtype -> [(path, shape, scale)]
    params = _empty_like_tree(meta)
    for path, m in leaves:
        name = path[-1]
        if name in ONES:
            _set(params, path, torch.ones(m.shape, dtype=m.dtype,
                                          device=device))
        elif m.dim() >= 2:
            mats.setdefault(m.dtype, []).append((path, m.shape,
                                                 _scale(name, m.shape)))
        else:
            raise ValueError(f"no rule for leaf {name!r} {tuple(m.shape)}")
    for dtype, entries in mats.items():
        total = sum(math.prod(s) for _, s, _ in entries)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape, scale in entries:
            n = math.prod(shape)
            _set(params, path, flat[off:off + n].view(shape).mul_(scale))
            off += n
    return params


def _empty_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _empty_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_empty_like_tree(v) for v in tree]
    return None
