"""Shared building blocks (counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors with the reference's key names.
Math accumulates in float32 and casts back to the activation dtype.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1) * scale (default fan_in**-0.5, fan_in = shape[-2] for a
    stacked weight), drawn in f32 from ``gen`` — the reference's
    distribution, not its numbers.  A stacked weight is drawn one matrix
    at a time and scaled in place, so the f32 draw of a full-width expert
    stack (arctic's 2 x 128 experts of 7168 x 4864) never exists whole.
    On ``meta`` (``gen`` None) it draws nothing."""
    fan_in = shape[0] if len(shape) <= 2 else shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                      # the dry-run's stand-in: no draw
        return out
    mats = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for m in mats:
        w = torch.randn(m.shape, generator=gen, dtype=torch.float32,
                        device=device)
        m.copy_(w.mul_(scale))
    return out


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


def yarn_mscale(scale: float, mscale: float) -> float:
    """``0.1 * mscale * ln(scale) + 1`` (1 where ``scale <= 1``), the YaRN
    attention scale of DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg, device=None) -> torch.Tensor:
    """The rotary inverse frequencies of the ``qk_rope_head_dim`` dims as
    DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` computes them: the
    interpolated ``freq_inter = freq_extra / factor`` where a dim turns
    fewer than ``beta_slow`` times over the original context, the original
    ``freq_extra`` where more than ``beta_fast``, a linear ramp between the
    floor and ceil of those two correction dims (at a factor of 1, plain
    RoPE frequencies)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (cfg.rope_yarn_factor * base ** exps)

    def correction_dim(rotations):
        return (dim * math.log(cfg.rope_yarn_original
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(cfg.rope_yarn_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp                   # 1: keep the original frequency
    return inter * (1 - mask) + extra * mask


def apply_rope_interleaved(x, positions, inv_freq, scale: float = 1.0):
    """DeepSeek-V2's rotary embedding in f32: the pairs ``(x[2i],
    x[2i+1])`` are first gathered into the half-split order (evens, then
    odds), then turned by ``positions * inv_freq[i]`` as :func:`apply_rope`
    turns them; the result stays in the half-split order, as the published
    code leaves it.  cos and sin carry ``scale`` (YaRN's mscale ratio).
    x: (..., seq, heads, dim); positions: (..., seq)."""
    dim = x.shape[-1]
    half = dim // 2
    xf = x.float().unflatten(-1, (half, 2)).transpose(-1, -2).flatten(-2)
    angles = positions[..., None].float() * inv_freq       # (..., seq, half)
    cos = (torch.cos(angles) * scale)[..., None, :]
    sin = (torch.sin(angles) * scale)[..., None, :]
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_mlp(gen, d_model, d_ff, mlp_type, dtype, *, reps, device=None):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or gelu (``w_up``,
    ``w_down``) weights, stacked over ``reps`` layers."""
    def w(*shape):
        return dense_init(gen, (reps, *shape), dtype=dtype, device=device)

    if mlp_type == "swiglu":
        return {"w_gate": w(d_model, d_ff), "w_up": w(d_model, d_ff),
                "w_down": w(d_ff, d_model)}
    return {"w_up": w(d_model, d_ff), "w_down": w(d_ff, d_model)}


def apply_mlp(params, x, mlp_type):
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down; gelu: gelu(x W_up),
    then W_down."""
    if mlp_type == "swiglu":
        h = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]
