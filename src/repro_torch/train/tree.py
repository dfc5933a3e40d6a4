"""Nested dict/list/tuple trees of tensors, walked in JAX's order.

``jax.tree.leaves`` visits a dict's keys sorted and a list's or tuple's
items in order; the reference's global norm, its modeled gradient-reduce
schedule and its checkpoint keys all follow that order, so the port walks
its trees the same way.  A path is the string ``jax.tree_util.keystr``
gives it, e.g. ``"[0]['blocks'][0]['attn']['wq']"``.
"""
from __future__ import annotations


def flatten(tree, prefix: str = ""):
    """[(path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves):
    """A tree shaped as ``like`` holding ``new_leaves`` in JAX's order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}       # keep the insertion order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in JAX's order; returns a tree shaped as ``tree``."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])
