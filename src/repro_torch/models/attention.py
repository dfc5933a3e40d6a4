"""GQA attention (counterpart of ``repro/models/attention.py``).

Prefill self-attention goes through the K2 flash kernel
(``kernels/flash_attn.py``, called from ``models/model.py``).  Decode
attention stays plain torch, as the reference computes it outside any
Pallas kernel: one query token against the cache, f32 softmax, masked
scores -1e30.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, dense_init, head_rms_norm

NEG_INF = -1e30


def init_attn(gen, cfg, dtype, *, reps, device=None):
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def w(shape):
        return dense_init(gen, (reps, *shape), dtype=dtype, device=device)

    p = {"wq": w((d, nq * hd)), "wk": w((d, nkv * hd)),
         "wv": w((d, nkv * hd)), "wo": w((nq * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((reps, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((reps, hd), dtype=dtype, device=device)
    return p


def project_q(p, x, cfg, positions=None):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(p, x, cfg, positions=None):
    B, S, _ = x.shape
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = head_rms_norm(k, p["k_norm"])
    if positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def full_attn(q, k, v, mask=None):
    """Unblocked attention.  q: (B,Sq,nq,hd); k,v: (B,Skv,nkv,hd); mask
    broadcastable to (B,nkv,g,Sq,Skv), or (B,Skv) validity."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qf = q.reshape(B, Sq, nkv, g, hd).float() * hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, None, None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nq, hd).to(q.dtype)


def decode_attn(q, k_cache, v_cache, valid_mask):
    """One-token attention against a cache.  q: (B,1,nq,hd); caches:
    (B,S,nkv,hd); valid_mask: (B,S) bool."""
    return full_attn(q, k_cache, v_cache, mask=valid_mask)
