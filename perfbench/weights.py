"""Weights drawn by the benchmark from the seed, on the device, in the
type they are served in, and handed alike to the program and to the
reference.

The program's layout (key names, stacked shapes, dtypes) is read from its
``init_params`` on ``meta``, which allocates and draws nothing.  The
values are the benchmark's: one ``randn`` call per dtype into a flat
buffer, each drawn leaf a view of it scaled in place.  Every leaf of every
configuration the port holds falls under one of three rules (``rule``):

- a key that names a norm (``norm`` at its start or end: ``norm1``,
  ``norm_x``, ``q_norm``, ``gnorm``, ``final_norm``) is ones;
- a matrix is drawn at fan_in^-0.5, fan_in its second-to-last axis (the
  embedding at 0.02);
- any other leaf, a vector a layer (Mamba2's ``A_log``, ``dt_bias``,
  ``D``, ``conv_b``, the cross block's ``gate``, the xLSTM biases), is
  drawn at ``VECTOR_SCALE``.

A leaf under ``blocks`` is stacked over the repeats of its layer on axis
0; that axis is set aside before a leaf is judged a matrix or a vector,
so it is never a fan-in.
"""
from __future__ import annotations

import math

import torch

EMBED_SCALE = 0.02
VECTOR_SCALE = 0.5


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


def rule(path: tuple, shape) -> float | None:
    """The scale leaf ``path`` of ``shape`` is drawn at, or None for
    ones."""
    name = path[-1]
    if name.startswith("norm") or name.endswith("norm"):
        return None
    core = tuple(shape)[1:] if "blocks" in path[:-1] else tuple(shape)
    if len(core) >= 2:
        return EMBED_SCALE if name == "embed" else core[-2] ** -0.5
    return VECTOR_SCALE


def make(cfg, seed: int, device) -> dict:
    """The program's parameter tree for ``cfg``, drawn from ``seed`` on
    ``device``."""
    from repro_torch.models import model
    meta = model.init_params(cfg, device="meta")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = {}      # dtype -> [(path, shape, scale)]
    params = _empty_like_tree(meta)
    for path, m in _paths(meta):
        scale = rule(path, m.shape)
        if scale is None:
            _set(params, path, torch.ones(m.shape, dtype=m.dtype,
                                          device=device))
        else:
            drawn.setdefault(m.dtype, []).append((path, m.shape, scale))
    for dtype, entries in drawn.items():
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
