"""Building blocks of the references: RMS norm, rotary embedding, causal
GQA attention with optional per-head q/k norm, SwiGLU, all in float32.

Every function takes a ``w`` callable that turns one stored weight (the
benchmark's bf16 tensor) into the float32 tensor the reference computes
with: a plain upcast for the reference, a rounding through a lower
precision for the control (:func:`fp8_weight`).
"""
from __future__ import annotations

import torch

EPS = 1e-6


def f32_weight(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def fp8_weight(t: torch.Tensor) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 under one
    scale per output column, back in float32.  Vectors (norms) stay."""
    t = t.float()
    if t.dim() < 2:
        return t
    amax = t.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def rms(x, weight, eps: float = EPS):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def rope(x, theta: float):
    """Half-split rotary embedding at positions 0..S-1.  x: (S, H, hd)."""
    S, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, x, a: dict, w, *, q_block: int = 512):
    """Causal self-attention of one sequence.  x: (S, d) float32; ``p``
    holds wq, wk, wv, wo (and q_norm, k_norm when ``a["qk_norm"]``)."""
    S = x.shape[0]
    nq, nkv = a["num_heads"], a["num_kv_heads"]
    hd = a["head_dim"] or a["d_model"] // nq
    q = (x @ w(p["wq"])).view(S, nq, hd)
    k = (x @ w(p["wk"])).view(S, nkv, hd)
    v = (x @ w(p["wv"])).view(S, nkv, hd)
    if a["qk_norm"]:
        q = rms(q, w(p["q_norm"]))
        k = rms(k, w(p["k_norm"]))
    q = rope(q, a["rope_theta"])
    k = rope(k, a["rope_theta"])
    g = nq // nkv
    k = k.repeat_interleave(g, dim=1)            # query head h reads h // g
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty((S, nq, hd), device=x.device)
    for q0 in range(0, S, q_block):
        q1 = min(S, q0 + q_block)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * hd ** -0.5
        qpos = torch.arange(q0, q1, device=x.device)[:, None]
        kpos = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    return out.reshape(S, nq * hd) @ w(p["wo"])


def swiglu(p, x, w):
    h = x @ w(p["w_gate"])
    return (h * torch.sigmoid(h) * (x @ w(p["w_up"]))) @ w(p["w_down"])


def attn_block(bp, x, a: dict, w):
    """Pre-norm attention then SwiGLU, both residual."""
    x = x + attention(bp["attn"], rms(x, w(bp["norm1"])), a, w)
    return x + swiglu(bp["mlp"], rms(x, w(bp["norm2"])), w)


def layer(tree, r: int):
    """Repeat ``r`` of a tree of weights stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    return tree[r]


def head(params, x, a: dict, w, rows):
    """Float32 logits of the final-normed hidden states at ``rows``."""
    x = rms(x[rows], w(params["final_norm"]))
    lm = (w(params["embed"]).T if a["tie_embeddings"]
          else w(params["lm_head"]))
    return x @ lm
