"""Sharding rules (counterpart of ``repro/launch/sharding.py``): parameters
(FSDP x TP hybrid), optimizer state, caches, batches and activation
constraints, for the production meshes and the card.

Policy (DESIGN.md §5), the reference's rule for rule:
  - weights: larger of the last two dims -> "model" (TP), the other ->
    "data" (ZeRO/FSDP); leading stack axes replicated; embeddings vocab ->
    "model";
  - MoE expert stacks: expert dim -> "model" (expert parallelism);
  - activations: batch -> ("pod", "data"); logits vocab -> "model";
  - decode caches: batch -> ("pod", "data") when divisible, sequence or
    window -> "model" (distributed flash-decode); SSM state heads ->
    "model".
All assignments are divisibility-checked; non-divisible dims replicate.

The port partitions nothing: a spec here says how the reference lays the
tensor out, and :func:`shard_shape` / :func:`per_device_bytes` size each
device's share for the dry-run.  Trees are the port's nested dicts and
lists; a path is ``jax.tree_util.keystr``'s (``train/tree.py``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import tree as tree_mod


@dataclasses.dataclass(frozen=True, init=False)
class P:
    """A partition spec: per dimension an axis name, a tuple of names or
    None (``jax.sharding.PartitionSpec``)."""
    parts: tuple

    def __init__(self, *parts):
        object.__setattr__(self, "parts", tuple(parts))

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __repr__(self):
        return f"P{self.parts!r}"


def _sizes(mesh):
    ax = dict(mesh.shape)
    batch_axes = mesh_mod.batch_axes(mesh)
    bsize = 1
    for a in batch_axes:
        bsize *= ax[a]
    return ax.get("model", 1), bsize, batch_axes


def _div(n, k):
    return k > 0 and n % k == 0


def _map_with_path(fn, tree):
    return tree_mod.unflatten(tree, [fn(path, leaf) for path, leaf
                                     in tree_mod.flatten(tree)])


# ---------------------------------------------------------------------------
# parameters / optimizer state
# ---------------------------------------------------------------------------


def _generic_matrix_spec(shape, msize, dsize):
    nd = len(shape)
    spec = [None] * nd
    if nd < 2:
        return P(*spec)
    a, b = nd - 2, nd - 1
    big, small = (a, b) if shape[a] >= shape[b] else (b, a)
    if _div(shape[big], msize):
        spec[big] = "model"
        if _div(shape[small], dsize):
            spec[small] = "data"
    elif _div(shape[small], msize):
        spec[small] = "model"
        if _div(shape[big], dsize):
            spec[big] = "data"
    elif _div(shape[big], dsize):
        spec[big] = "data"
    return P(*spec)


def spec_for_param(path: str, shape, mesh) -> P:
    from repro_torch.launch import policy as policy_mod
    msize, _, _ = _sizes(mesh)
    dsize = dict(mesh.shape).get("data", 1)
    if policy_mod.get().param_tp_only and "blocks" in path:
        dsize = -1                       # never divisible -> no "data" shard
    nd = len(shape)
    if "embed" in path and nd == 2:
        v, d = shape
        return P("model" if _div(v, msize) else None,
                 "data" if _div(d, dsize) else None)
    if "lm_head" in path and nd == 2:
        d, v = shape
        if _div(v, msize):
            return P("data" if _div(d, dsize) else None, "model")
        return P("model" if _div(d, msize) else None, None)
    if "router" in path and nd == 3:
        return P(None, "data" if _div(shape[1], dsize) else None, None)
    if ("moe" in path and nd == 4
            and any(k in path for k in ("w_gate", "w_up", "w_down"))):
        e = shape[1]
        return P(None,
                 "model" if _div(e, msize) else None,
                 "data" if _div(shape[2], dsize) else None,
                 None)
    if nd >= 2:
        # strip leading stack axes; rule over the last two dims
        spec = _generic_matrix_spec(shape[-2:], msize, dsize)
        return P(*([None] * (nd - 2) + list(spec)))
    return P()


def param_shardings(cfg, mesh, params):
    return _map_with_path(
        lambda path, leaf: spec_for_param(path, tuple(leaf.shape), mesh),
        params)


def opt_shardings(cfg, mesh, opt_state):
    """Optimizer state: the same generic rules (m/v mirror params;
    adafactor vr/vc get the generic treatment of their reduced shapes)."""
    def one(path, leaf):
        if leaf.dim() == 0:
            return P()
        return spec_for_param(path, tuple(leaf.shape), mesh)
    return _map_with_path(one, opt_state)


# ---------------------------------------------------------------------------
# batches / caches
# ---------------------------------------------------------------------------


def batch_shardings(cfg, mesh, batch):
    msize, bsize, baxes = _sizes(mesh)
    baxes = tuple(baxes)

    def one(path, leaf):
        first = baxes if (_div(leaf.shape[0], bsize) and baxes) else None
        return P(first, *([None] * (leaf.dim() - 1)))
    return _map_with_path(one, batch)


def cache_shardings(cfg, mesh, cache):
    from repro_torch.launch import policy as policy_mod
    msize, bsize, baxes = _sizes(mesh)
    baxes = tuple(baxes)

    pol = policy_mod.get()
    if pol.decode_replicate_small_cache:
        total = sum(leaf.numel() * leaf.element_size()
                    for leaf in tree_mod.leaves(cache))
        if total <= pol.small_cache_bytes:
            # latency-bound decode over a small (windowed/SSM) cache:
            # replicate rather than shard
            return tree_mod.map_leaves(lambda l: P(*([None] * l.dim())),
                                       cache)

    def one(path, leaf):
        nd = leaf.dim()
        spec = [None] * nd
        name = path.rsplit("'", 2)[-2] if "'" in path else path
        if nd >= 2:
            b = leaf.shape[1]            # (R, B, ...)
            if _div(b, bsize) and baxes:
                spec[1] = baxes
        if name in ("k", "v", "ck", "cv") and nd == 5:
            seq, nkv = leaf.shape[2], leaf.shape[3]
            if spec[1] is None and _div(seq, bsize * msize):
                spec[2] = tuple(baxes) + ("model",)   # B=1: context parallel
            elif _div(seq, msize):
                spec[2] = "model"
            elif _div(nkv, msize):
                spec[3] = "model"
        elif name == "kpos" and nd == 3:
            seq = leaf.shape[2]
            if spec[1] is None and _div(seq, bsize * msize):
                spec[2] = tuple(baxes) + ("model",)
            elif _div(seq, msize):
                spec[2] = "model"
        elif name == "state" and nd == 5:
            if _div(leaf.shape[2], msize):
                spec[2] = "model"
        elif name == "conv" and nd == 4:
            if _div(leaf.shape[3], msize):
                spec[3] = "model"
        elif name in ("C", "n") and nd >= 4:
            if _div(leaf.shape[2], msize):
                spec[2] = "model"
        return P(*spec)
    return _map_with_path(one, cache)


# ---------------------------------------------------------------------------
# activation constraint rules (installed via launch.shardctx)
# ---------------------------------------------------------------------------


def activation_rules(cfg, mesh):
    msize, bsize, baxes = _sizes(mesh)
    baxes = tuple(baxes)

    def rule(role, shape):
        if not baxes:
            return None
        if role == "gathered_weight":
            # ZeRO-3 weight gathering: inside the layer body the weight is
            # replicated across the data axis, sharded only on "model"
            if len(shape) < 2:
                return P(*([None] * len(shape)))
            spec = list(_generic_matrix_spec(shape[-2:], msize, 1))
            spec = [s if s == "model" else None for s in spec]
            if len(shape) == 3 and _div(shape[0], msize):  # (E, d, ff)
                return P("model", None, None)
            return P(*([None] * (len(shape) - 2) + spec))
        b = shape[0]
        first = baxes if _div(b, bsize) else None
        if role == "hidden" and len(shape) == 3:
            from repro_torch.launch import policy as policy_mod
            pol = policy_mod.get()
            if pol.hidden_spec == "off":
                return None
            if (pol.seq_parallel_hidden
                    and _div(shape[1], msize) and shape[1] > 1):
                return P(first, "model", None)   # sequence parallelism
            if pol.hidden_spec == "dshard" and _div(shape[2], msize):
                return P(first, None, "model")
            return P(first, None, None)
        if role == "logits" and len(shape) == 3:
            v = shape[-1]
            return P(first, None, "model" if _div(v, msize) else None)
        return None
    return rule


# ---------------------------------------------------------------------------
# each device's share
# ---------------------------------------------------------------------------


def shard_shape(shape, spec: P, mesh) -> tuple:
    """The per-device block of a ``shape`` laid out by ``spec`` on
    ``mesh``; raises where an axis does not divide its dimension."""
    sizes = dict(mesh.shape)
    out = list(shape)
    for i, s in enumerate(spec):
        if s is None:
            continue
        k = math.prod(sizes[a] for a in (s if isinstance(s, tuple) else (s,)))
        if out[i] % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over "
                             f"{s} ({k})")
        out[i] //= k
    return tuple(out)


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by the matching tree of
    ``specs``."""
    total = 0
    for leaf, spec in zip(tree_mod.leaves(tree), tree_mod.leaves(specs)):
        total += math.prod(shard_shape(tuple(leaf.shape), spec, mesh)) * \
            leaf.element_size()
    return total
