"""Shared building blocks (counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors with the reference's key names.
Math accumulates in float32 and casts back to the activation dtype.
"""
from __future__ import annotations

import torch


def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in**-0.5, fan_in = shape[-2] for a
    stacked weight), drawn in f32 from ``gen`` — the reference's
    distribution, not its numbers."""
    fan_in = shape[0] if len(shape) <= 2 else shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def rms_norm(x, weight, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(dt)


def head_rms_norm(x, weight, eps=1e-6):
    """Per-head RMS norm over the trailing head_dim (qwen3 qk_norm)."""
    return rms_norm(x, weight, eps)


def silu(x):
    return x * torch.sigmoid(x)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """Half-split RoPE in f32.  x: (..., seq, heads, head_dim); positions:
    (..., seq) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs      # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]              # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model, d_ff, mlp_type, dtype, *, reps, device=None):
    """SwiGLU weights stacked over ``reps`` layers."""
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} comes with the "
                                  "remaining model families (ROADMAP queue "
                                  "1, item 7)")
    return {
        "w_gate": dense_init(gen, (reps, d_model, d_ff), dtype=dtype,
                             device=device),
        "w_up": dense_init(gen, (reps, d_model, d_ff), dtype=dtype,
                           device=device),
        "w_down": dense_init(gen, (reps, d_ff, d_model), dtype=dtype,
                             device=device),
    }


def apply_mlp(params, x):
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down."""
    h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
