"""Decode caches (counterpart of ``repro/models/kvcache.py``).

One entry per repeat-unit position, every leaf stacked over the unit's
repeats on axis 0: a self-attention entry (``attn``, ``shared_attn``,
``moe``, ``encdec``) is ``{"k", "v"}`` of shape ``(reps, B, W, nkv, hd)``;
an ``encdec`` entry adds the encoder output's projected ``ck``/``cv`` over
``encoder_seq`` frames, a ``cross`` entry holds only ``ck``/``cv`` over
``image_tokens``; the recurrent entries hold f32 states (``mamba``:
``state`` and ``conv``; ``mlstm``: ``C``, ``n``, ``m``; ``slstm``: ``c``,
``n``, ``m``, ``h``).  A latent-attention model (``mla``, ``mla_moe``)
has one entry whatever its layer kinds, ``{"ckv"}`` of shape
``(num_layers, B, W, 1, kv_lora_rank + qk_rope_head_dim)``: each layer's
row a token, the normed latent and the shared rotary key
(``models/attention.py::mla_decode``), stacked in layer order
(:func:`entry_of`), so the pool pages one leaf.

Self-attention caches are dense (``seq_len`` slots, valid while slot <=
pos) or a ring of ``window`` slots when the architecture is windowed at
that context length (SWA; a hybrid above 65,536 tokens): a ring adds an
int32 ``kpos`` of the position each slot holds, -1 when empty.
"""
from __future__ import annotations

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import attention as attn_mod, ssm as ssm_mod


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
    nkv, hd, dt = cfg.num_kv_heads, cfg.hd, cfg.dtype
    W = self_cache_len(cfg, seq_len)
    if kind in ("attn", "moe", "shared_attn", "encdec"):
        e = {"k": ((batch, W, nkv, hd), dt), "v": ((batch, W, nkv, hd), dt)}
        if is_ring(cfg, seq_len):
            e["kpos"] = ((batch, W), "int32")
        if kind == "encdec":
            e["ck"] = ((batch, cfg.encoder_seq, nkv, hd), dt)
            e["cv"] = ((batch, cfg.encoder_seq, nkv, hd), dt)
        return e
    if kind == "cross":
        return {"ck": ((batch, cfg.image_tokens, nkv, hd), dt),
                "cv": ((batch, cfg.image_tokens, nkv, hd), dt)}
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
    raise ValueError(kind)


def entry_of(cfg, unit_len: int, i: int, r: int) -> tuple:
    """(entry, index on its axis 0) of the cache that position ``i`` of
    repeat ``r`` of the layer unit reads: its own entry's repeat ``r``, or
    under latent attention the one entry's layer ``r * unit_len + i``."""
    if cfg.kv_lora_rank:
        return 0, r * unit_len + i
    return i, r


def cache_shapes(cfg, batch: int, seq_len: int) -> dict:
    """``{"blocks": [{key: (shape, dtype name)}]}`` of the decode cache."""
    if cfg.kv_lora_rank:
        W = self_cache_len(cfg, seq_len)
        return {"blocks": [{"ckv": ((cfg.num_layers, batch, W, 1,
                                     attn_mod.mla_row_width(cfg)),
                                    cfg.dtype)}]}
    unit, reps = cfgbase.repeat_unit(cfg)
    return {"blocks": [
        {key: ((reps, *shape), dt)
         for key, (shape, dt) in _entry(kind, cfg, batch, seq_len).items()}
        for kind in unit]}


def cache_struct(cfg, batch: int, seq_len: int) -> dict:
    """The decode cache as ``meta`` tensors (the dry-run's stand-in), leaf
    for leaf the reference's ``cache_struct``."""
    return {"blocks": [
        {key: torch.empty(shape, dtype=getattr(torch, dt), device="meta")
         for key, (shape, dt) in entry.items()}
        for entry in cache_shapes(cfg, batch, seq_len)["blocks"]]}


def init_cache(cfg, batch: int, seq_len: int, device,
               skip=frozenset()) -> dict:
    """Zeros, and -1 (empty) in a ring's ``kpos``; without the leaves
    ``(entry index, key)`` in ``skip``."""
    return {"blocks": [
        {key: torch.full(shape, -1 if key == "kpos" else 0,
                         dtype=getattr(torch, dt), device=device)
         for key, (shape, dt) in entry.items() if (ui, key) not in skip}
        for ui, entry in enumerate(
            cache_shapes(cfg, batch, seq_len)["blocks"])]}
