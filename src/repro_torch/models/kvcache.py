"""Decode caches (counterpart of ``repro/models/kvcache.py``).

One entry per repeat-unit position, every leaf stacked over the unit's
repeats on axis 0: a self-attention entry (``attn``, ``shared_attn``) is
``{"k", "v"}`` of shape ``(reps, B, W, nkv, hd)``; the recurrent entries
hold f32 states (``mamba``: ``state`` and ``conv``; ``mlstm``: ``C``, ``n``,
``m``; ``slstm``: ``c``, ``n``, ``m``, ``h``).  Ring caches (SWA, and a
hybrid above 65,536 tokens) and the cross and encoder states come with
their families (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import ssm as ssm_mod


def self_cache_len(cfg, seq_len: int) -> int:
    if cfg.attention == "swa":
        return min(cfg.window, seq_len)
    if cfg.family == "hybrid" and seq_len > 65_536:
        return min(cfg.window, seq_len)
    return seq_len


def is_ring(cfg, seq_len: int) -> bool:
    return self_cache_len(cfg, seq_len) < seq_len


def _entry(kind, cfg, batch, seq_len) -> dict:
    """``{key: (per-repeat shape, dtype name)}`` of one unit position."""
    if kind in ("attn", "shared_attn"):
        shape = (batch, self_cache_len(cfg, seq_len), cfg.num_kv_heads,
                 cfg.hd)
        return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
    if kind == "mamba":
        d_in, p, nh, N = ssm_mod.mamba_dims(cfg)
        return {"state": ((batch, nh, p, N), "float32"),
                "conv": ((batch, cfg.ssm_conv - 1, d_in + 2 * N),
                         "float32")}
    if kind == "mlstm":
        d_in, nh, dk = ssm_mod.mlstm_dims(cfg)
        return {"C": ((batch, nh, dk, dk), "float32"),
                "n": ((batch, nh, dk), "float32"),
                "m": ((batch, nh), "float32")}
    if kind == "slstm":
        return {key: ((batch, cfg.d_model), "float32") for key in "cnmh"}
    raise NotImplementedError(
        f"{cfg.name}: no {kind!r} cache is ported (ROADMAP queue 1, item 7)")


def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    """``{"blocks": [{key: (shape, dtype name)}]}`` of the decode cache."""
    unit, reps = cfgbase.repeat_unit(cfg)
    if is_ring(cfg, seq_len):
        raise NotImplementedError(
            f"{cfg.name}: ring caches at {seq_len} tokens are not ported "
            "(ROADMAP queue 1, item 7)")
    return {"blocks": [
        {key: ((reps, *shape), dt)
         for key, (shape, dt) in _entry(kind, cfg, batch, seq_len).items()}
        for kind in unit]}


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    return {"blocks": [
        {key: torch.zeros(shape, dtype=getattr(torch, dt),
                          device=device)
         for key, (shape, dt) in entry.items()}
        for entry in cache_shapes(cfg, batch, seq_len)["blocks"]]}
