"""Model assembly for the ``attn``, ``shared_attn``, ``mamba``, ``mlstm``
and ``slstm`` block kinds (counterpart of ``repro/models/model.py``).

``init_params(cfg)`` builds a nested dict with the reference's key names;
per-layer weights are stacked over the repeats of the layer unit (axis 0),
and the forward passes loop over the repeats.  Zamba2's one weight-shared
attention block lives at ``params["shared_attn"]`` (unstacked), with a
``{}`` placeholder at its position in ``params["blocks"]``; every repeat
keeps its own K/V cache.  Two step kinds:

- ``prefill``     : full-prompt forward that fills the decode cache;
- ``decode_step`` : ONE token against the cache.

Prefill self-attention always goes through the K2 flash kernel (its plain
version for CPU tensors): the reference's ``attn_impl`` switch has no
counterpart.  ``shardctx.constrain`` has none either.  Training, the
encoder, MoE, cross-attention and windowed attention come with their
slices (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import torch

from repro_torch import _devices
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import flash_attn
from repro_torch.models import attention as attn_mod, ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, \
    rms_norm


PORTED_KINDS = ("attn", "shared_attn", "mamba", "mlstm", "slstm")


def _check_kinds(cfg):
    unit, reps = cfgbase.repeat_unit(cfg)
    if any(kind not in PORTED_KINDS for kind in unit) or \
            cfg.attention != "full":
        raise NotImplementedError(
            f"{cfg.name}: only full-attention {PORTED_KINDS} blocks are "
            "ported (ROADMAP queue 1, item 7)")
    return unit, reps


def _init_block(gen, kind, cfg, dtype, reps, dev):
    d = cfg.d_model
    if kind in ("attn", "shared_attn"):
        bp = {"norm1": torch.ones((reps, d), dtype=dtype, device=dev),
              "attn": attn_mod.init_attn(gen, cfg, dtype, reps=reps,
                                         device=dev)}
        if cfg.d_ff:
            bp["norm2"] = torch.ones((reps, d), dtype=dtype, device=dev)
            bp["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype,
                                 reps=reps, device=dev)
        return bp
    init = {"mamba": ssm_mod.init_mamba, "mlstm": ssm_mod.init_mlstm,
            "slstm": ssm_mod.init_slstm}[kind]
    return init(gen, cfg, dtype, reps=reps, device=dev)


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
    for kind in unit:
        if kind == "shared_attn":
            # zamba2: ONE weight-shared attention block used at every repeat
            params["shared_attn"] = _layer(
                _init_block(gen, kind, cfg, dtype, 1, dev), 0)
            blocks.append({})          # placeholder slot in the stack
            continue
        blocks.append(_init_block(gen, kind, cfg, dtype, reps, dev))
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


def apply_block(kind, bp, x, *, cfg, mode, positions=None, cache=None,
                pos=None):
    """Returns (x_out, new cache entries).  Prefill starts every recurrent
    state from zero, as the reference does, and returns the end state."""
    if kind in ("attn", "shared_attn"):
        h = rms_norm(x, bp["norm1"])
        o, new_cache = _self_attention(bp["attn"], h, cfg, mode, positions,
                                       cache, pos)
        x = x + o
        if cfg.d_ff:
            x = x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]))
        return x, new_cache
    h = rms_norm(x, bp["norm"])
    if kind == "mamba":
        if mode == "decode":
            y, state, conv = ssm_mod.mamba_decode(bp, h, cfg, cache["state"],
                                                  cache["conv"])
        else:
            y, state, conv = ssm_mod.mamba_forward(bp, h, cfg)
        return x + y, {"state": state, "conv": conv}
    if kind == "mlstm":
        if mode == "decode":
            y, st = ssm_mod.mlstm_decode(bp, h, cfg, (cache["C"], cache["n"],
                                                      cache["m"]))
        else:
            y, st = ssm_mod.mlstm_forward(bp, h, cfg)
        return x + y, dict(zip(("C", "n", "m"), st))
    if kind == "slstm":
        if mode == "decode":
            y, st = ssm_mod.slstm_decode(
                bp, h, cfg, tuple(cache[k] for k in "cnmh"))
        else:
            y, st = ssm_mod.slstm_forward(bp, h, cfg)
        return x + y, dict(zip("cnmh", st))
    raise ValueError(kind)


def backbone(params, cfg, x, *, mode, positions=None, cache=None, pos=None):
    """x: (B,S,d) embedded inputs.  Returns (x, new_cache)."""
    unit, reps = _check_kinds(cfg)
    shared = params.get("shared_attn")
    new_blocks = [{} for _ in unit]
    for r in range(reps):
        for i, kind in enumerate(unit):
            bp = shared if kind == "shared_attn" else \
                _layer(params["blocks"][i], r)
            c = _layer(cache["blocks"][i], r) if cache is not None else None
            x, nc = apply_block(kind, bp, x, cfg=cfg, mode=mode,
                                positions=positions, cache=c, pos=pos)
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
