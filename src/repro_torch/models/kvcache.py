"""Decode caches (counterpart of ``repro/models/kvcache.py``).

One entry per repeat-unit position, every leaf stacked over the unit's
repeats on axis 0: a self-attention entry is ``{"k", "v"}`` of shape
``(reps, B, W, nkv, hd)``.  Only the dense self-attention entry of the
``attn`` kind is ported; ring (SWA) caches and the recurrent, cross and
encoder states come with their families (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import torch

from repro_torch.configs import base as cfgbase


def self_cache_len(cfg, seq_len: int) -> int:
    if cfg.attention == "swa":
        return min(cfg.window, seq_len)
    if cfg.family == "hybrid" and seq_len > 65_536:
        return min(cfg.window, seq_len)
    return seq_len


def is_ring(cfg, seq_len: int) -> bool:
    return self_cache_len(cfg, seq_len) < seq_len


def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    """``{"blocks": [{key: (shape, dtype name)}]}`` of the decode cache."""
    unit, reps = cfgbase.repeat_unit(cfg)
    if any(kind != "attn" for kind in unit) or is_ring(cfg, seq_len):
        raise NotImplementedError(
            f"{cfg.name}: only dense self-attention caches are ported "
            "(ROADMAP queue 1, item 7)")
    W = self_cache_len(cfg, seq_len)
    shape = (reps, batch, W, cfg.num_kv_heads, cfg.hd)
    return {"blocks": [{"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
                       for _ in unit]}


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    return {"blocks": [
        {key: torch.zeros(shape, dtype=getattr(torch, dt),
                          device=device)
         for key, (shape, dt) in entry.items()}
        for entry in cache_shapes(cfg, batch, seq_len)["blocks"]]}
