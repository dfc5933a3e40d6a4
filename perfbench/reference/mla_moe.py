"""DeepSeek-V2 decoder (deepseek-v2-lite): embedding; per layer pre-norm
multi-head latent attention with YaRN rotary positions, then, residual,
a SwiGLU MLP (the first ``first_k_dense`` layers) or DeepSeekMoE; final
norm and the untied LM head.  The equations of DeepSeek-V2
(arXiv:2405.04434) and of the ``modeling_deepseek.py`` its model repo
publishes, with no q LoRA:

- attention, expanded over the whole sequence: q = x Wq, split per head
  into q_nope and q_pe; [c, k_pe] = x W_kv_a; the latent c is RMS-normed
  and lifted by W_kv_b to each head's k_nope and v; q_pe and the one k_pe
  of a token are turned by the rotary embedding; each head attends with
  q = [q_nope, q_pe], k = [k_nope, k_pe] at scale (nope + rope)^-0.5 x
  mscale(factor, mscale_all_dim)^2, mscale(s, m) = 0.1 m ln s + 1;
- rotary: YaRN's inverse frequencies (the interpolated ones, the original
  divided by ``factor``, below the correction dim of ``beta_slow``, the
  original above that of ``beta_fast``, a linear ramp between), on the
  pairs (x[2i], x[2i+1]), cos and sin scaled by mscale(factor, mscale) /
  mscale(factor, mscale_all_dim);
- DeepSeekMoE: f32 router logits, a softmax over the routed experts, the
  top ``experts_per_token`` taken greedily, the gates renormalised only
  under ``norm_topk_prob``, times the published routed_scaling_factor of
  1; each token runs through its own experts only, plus the shared experts
  (one SwiGLU of ``moe_dense_ff``, the published n_shared x width).

Departures, none of which changes the function: the rotary angles are
computed in float64 and rounded to float32 (the published code forms them
in float32); the pairs are turned in place as complex numbers (the
published code leaves q_pe and k_pe de-interleaved, which changes no dot
product); router ties go to the lower expert index (``torch.topk``'s order
is unspecified).  Weights are read by the benchmark's key names: the
layer i's weights are ``params["blocks"][i]``, stacked over one repeat.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import common


def yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(a: dict) -> torch.Tensor:
    """Float64 inverse frequencies of the rotary dims under YaRN."""
    dim, base = a["qk_rope_head_dim"], a["rope_theta"]
    extra = base ** -(torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    factor = a["rope_yarn_factor"]

    def corr(rotations):
        return (dim * math.log(a["rope_yarn_original"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(a["rope_yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(a["rope_yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def softmax_scale(a: dict) -> float:
    m = yarn_mscale(a["rope_yarn_factor"], a["rope_yarn_mscale_all_dim"])
    return (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) ** -0.5 * m * m


def rotate(x, a: dict):
    """The rotary embedding of x: (S, H, rope) at positions 0..S-1, each
    pair (x[2i], x[2i+1]) turned as one complex number."""
    S = x.shape[0]
    ang = torch.arange(S, dtype=torch.float64)[:, None] * yarn_inv_freq(a)
    f, m = a["rope_yarn_factor"], a["rope_yarn_mscale"]
    scale = yarn_mscale(f, m) / yarn_mscale(f, a["rope_yarn_mscale_all_dim"])
    turn = torch.polar(torch.full_like(ang, scale), ang).to(
        torch.complex64).to(x.device)[:, None, :]
    pairs = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2)
                                  .contiguous())
    return torch.view_as_real(pairs * turn).reshape(x.shape)


def attention(p, x, a: dict, w, *, q_block: int = 512):
    """Causal multi-head latent attention of one sequence, expanded.
    x: (S, d) float32."""
    S = x.shape[0]
    H, r = a["num_heads"], a["kv_lora_rank"]
    dn, dv = a["qk_nope_head_dim"], a["v_head_dim"]
    q = (x @ w(p["wq"])).view(S, H, -1)
    ckv = x @ w(p["wkv_a"])
    kv = (common.rms(ckv[:, :r], w(p["kv_norm"])) @ w(p["wkv_b"])).view(
        S, H, dn + dv)
    k_pe = rotate(ckv[:, None, r:], a)
    q = torch.cat([q[..., :dn], rotate(q[..., dn:], a)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, k_pe.shape[-1])], dim=-1)
    v = kv[..., dn:]
    scale = softmax_scale(a)
    out = torch.empty((S, H, dv), device=x.device)
    for q0 in range(0, S, q_block):
        q1 = min(S, q0 + q_block)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        qpos = torch.arange(q0, q1, device=x.device)[:, None]
        kpos = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:q1])
    return out.reshape(S, H * dv) @ w(p["wo"])


def moe(p, x, a: dict, w):
    """DeepSeekMoE of x: (T, d): each token through its own top-k routed
    experts, weighted by their gates, plus the shared experts."""
    probs = torch.softmax(x @ w(p["router"]), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = a["experts_per_token"]
    gate, idx = gate[:, :k], idx[:, :k]
    if a["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(a["num_experts"]):
        rows, which = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        expert = {name: p[name][e] for name in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, rows, gate[rows, which, None]
                     * common.swiglu(expert, x[rows], w))
    return y + common.swiglu(p["dense_mlp"], x, w)


def logits(params, a: dict, tokens: torch.Tensor, rows, w=common.f32_weight):
    """Float32 logits at positions ``rows`` of the sequence ``tokens``
    ((S,) int64), which attends causally over itself."""
    x = w(params["embed"])[tokens]
    for i in range(a["num_layers"]):
        bp = common.layer(params["blocks"][i], 0)
        x = x + attention(bp["attn"], common.rms(x, w(bp["norm1"])), a, w)
        h = common.rms(x, w(bp["norm2"]))
        x = x + (common.swiglu(bp["mlp"], h, w) if i < a["first_k_dense"]
                 else moe(bp["moe"], h, a, w))
    return common.head(params, x, a, w, rows)
