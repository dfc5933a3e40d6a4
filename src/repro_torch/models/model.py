"""Model assembly for the ``attn`` block kind (counterpart of
``repro/models/model.py``).

``init_params(cfg)`` builds a nested dict with the reference's key names;
per-layer weights are stacked over the repeats of the layer unit (axis 0),
and the forward passes loop over the repeats.  Two step kinds:

- ``prefill``     : full-prompt forward that fills the decode cache;
- ``decode_step`` : ONE token against the cache.

Prefill self-attention always goes through the K2 flash kernel (its plain
version for CPU tensors): the reference's ``attn_impl`` switch has no
counterpart.  ``shardctx.constrain`` has none either.  Training, the
encoder and the other block kinds come with their slices.
"""
from __future__ import annotations

import torch

from repro_torch import _devices
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import flash_attn
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, \
    rms_norm


def _check_kinds(cfg):
    unit, reps = cfgbase.repeat_unit(cfg)
    if any(kind != "attn" for kind in unit) or cfg.attention != "full":
        raise NotImplementedError(
            f"{cfg.name}: only full-attention 'attn' blocks are ported "
            "(ROADMAP queue 1, item 7)")
    return unit, reps


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random weights with the reference's distributions (``dense_init``),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the current CUDA device unless given)."""
    dev = _devices.resolve(device)
    unit, reps = _check_kinds(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype, device=dev),
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype,
                                       device=dev)
    blocks = []
    for _ in unit:
        bp = {"norm1": ones(reps, d),
              "attn": attn_mod.init_attn(gen, cfg, dtype, reps=reps,
                                         device=dev)}
        if cfg.d_ff:
            bp["norm2"] = ones(reps, d)
            bp["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype,
                                 reps=reps, device=dev)
        blocks.append(bp)
    params["blocks"] = blocks
    return params


def _layer(tree, r):
    """Repeat ``r`` of a stacked parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _self_attention(p, x, cfg, mode, positions, cache, pos):
    """Returns (attn_out, new cache entries)."""
    flat = lambda o: o.reshape(o.shape[0], o.shape[1], -1)
    if mode == "prefill":
        q = attn_mod.project_q(p, x, cfg, positions)
        k, v = attn_mod.project_kv(p, x, cfg, positions)
        o = flash_attn.flash_attention(q, k, v)
        new = {}
        if cache is not None:               # dense cache, W >= S
            S = x.shape[1]
            new["k"] = torch.zeros_like(cache["k"])
            new["k"][:, :S] = k.to(cache["k"].dtype)
            new["v"] = torch.zeros_like(cache["v"])
            new["v"][:, :S] = v.to(cache["v"].dtype)
        return flat(o) @ p["wo"], new
    # ---- decode: one token per row at its own position -------------------
    q = attn_mod.project_q(p, x, cfg, pos[:, None])
    k, v = attn_mod.project_kv(p, x, cfg, pos[:, None])
    W = cache["k"].shape[1]
    # one-hot select, not a scatter: a position past the cache is dropped
    # (the reference's out-of-bounds rule) and the write needs no sync
    hot = (torch.arange(W, device=pos.device)[None, :] == pos[:, None])
    hot = hot[:, :, None, None]
    k_cache = torch.where(hot, k.to(cache["k"].dtype), cache["k"])
    v_cache = torch.where(hot, v.to(cache["v"].dtype), cache["v"])
    valid = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    o = attn_mod.decode_attn(q, k_cache, v_cache, valid)
    return flat(o) @ p["wo"], {"k": k_cache, "v": v_cache}


def _attn_block(bp, x, cfg, mode, positions, cache, pos):
    h = rms_norm(x, bp["norm1"])
    o, new_cache = _self_attention(bp["attn"], h, cfg, mode, positions,
                                   cache, pos)
    x = x + o
    if cfg.d_ff:
        x = x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]))
    return x, new_cache


def backbone(params, cfg, x, *, mode, positions=None, cache=None, pos=None):
    """x: (B,S,d) embedded inputs.  Returns (x, new_cache)."""
    unit, reps = _check_kinds(cfg)
    new_blocks = [{} for _ in unit]
    for r in range(reps):
        for i in range(len(unit)):
            c = _layer(cache["blocks"][i], r) if cache is not None else None
            x, nc = _attn_block(_layer(params["blocks"][i], r), x, cfg, mode,
                                positions, c, pos)
            for key, leaf in nc.items():
                new_blocks[i].setdefault(key, []).append(leaf)
    if cache is None:
        return x, None
    return x, {"blocks": [{k: torch.stack(v) for k, v in b.items()}
                          for b in new_blocks]}


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(cfg.activation_dtype())


def _lm_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def prefill(params, cfg, batch, cache):
    """Fill the cache from a full prompt; returns (last_logits f32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, new_cache = backbone(params, cfg, x, mode="prefill",
                            positions=positions, cache=cache)
    x = rms_norm(x[:, -1:], params["final_norm"])
    logits = (x @ _lm_matrix(params, cfg)).float()
    return logits[:, 0], new_cache


def decode_step(params, cfg, token, pos, cache):
    """ONE token (B,1) at positions pos (B,) against the cache."""
    x = _embed(params, cfg, token)
    x, new_cache = backbone(params, cfg, x, mode="decode", cache=cache,
                            pos=pos)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _lm_matrix(params, cfg)).float()
    return logits[:, 0], new_cache
