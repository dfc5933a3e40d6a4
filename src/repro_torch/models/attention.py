"""GQA attention (counterpart of ``repro/models/attention.py``).

Prefill self-attention goes through the K2 flash kernel
(``kernels/flash_attn.py``, called from ``models/model.py``), except a
sliding window's, which goes through :func:`blockwise_causal_attn`.
Training never calls K2, which has no backward: it takes
:func:`full_attn` under a causal mask up to 1024 tokens and
:func:`blockwise_causal_attn` above that or under a window, as the
reference's default policy does.  That,
the encoder's and cross-attention's :func:`full_attn` and decode attention
stay plain torch, as the reference computes them outside any Pallas
kernel: f32 scores and softmax, masked scores -1e30.
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


def _pick_block(s, want):
    b = min(want, s)
    while s % b:
        b -= 1
    return max(b, 1)


def blockwise_causal_attn(q, k, v, *, window=None, block_q=None,
                          block_k=None):
    """Online-softmax causal attention over KV blocks, optionally within a
    sliding ``window`` (a key at distance ``window`` or more is masked, and
    KV blocks wholly before the window are skipped).  Block sizes default
    to the policy's ``attn_block_q/k``; ``attn_qk_bf16`` keeps q and k in
    their dtype into the score product (f32 accumulation, scaled after),
    ``attn_p_bf16`` rounds P and V to bf16 before P.V (f32 accumulation);
    by default q*scale, scores and P are f32.  Differentiable: every
    update makes a new tensor.  q: (B,S,nq,hd); k,v: (B,S,nkv,hd)."""
    from repro_torch.launch import policy as policy_mod
    pol = policy_mod.get()
    block_q = block_q or pol.attn_block_q
    block_k = block_k or pol.attn_block_k
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    bq, bk = _pick_block(S, block_q), _pick_block(S, block_k)
    scale = hd ** -0.5
    qb = q.reshape(B, S // bq, bq, nkv, g, hd)
    kb = k.reshape(B, S // bk, bk, nkv, hd)
    vb = v.reshape(B, S // bk, bk, nkv, hd)
    # products of bf16-rounded operands are exact in f32, so an f32 einsum
    # over them is the reference's preferred_element_type=f32 product
    p_cast = (lambda t: t.bfloat16().float()) if pol.attn_p_bf16 else \
        (lambda t: t.float())
    outs = []
    for qi in range(S // bq):
        if pol.attn_qk_bf16:
            q_i = qb[:, qi].float()                      # q's own values
        else:
            q_i = qb[:, qi].float() * scale              # (B,bq,nkv,g,hd)
        q_start = qi * bq
        qpos = q_start + torch.arange(bq, device=q.device)
        k_hi = min(S // bk, (q_start + bq + bk - 1) // bk)   # exclusive
        k_lo = 0 if window is None else \
            max(0, q_start - int(window) + 1) // bk
        m = torch.full((B, nkv, g, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, nkv, g, bq), device=q.device)
        acc = torch.zeros((B, nkv, g, bq, hd), device=q.device)
        for kj in range(k_lo, k_hi):
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i, kb[:, kj].float())
            if pol.attn_qk_bf16:
                s = s * scale
            kpos = kj * bk + torch.arange(bk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - int(window))
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p_cast(p), p_cast(vb[:, kj]))
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]          # (B,nkv,g,bq,hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, bq, nq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


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
