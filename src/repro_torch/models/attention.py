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

Multi-head latent attention (DeepSeek-V2, :func:`init_mla`) has no
counterpart in the reference.  Its cache holds one row a token: the
RMS-normed latent of ``kv_lora_rank`` values and the one rotary key of
``qk_rope_head_dim`` shared by every head.  Prefill and training run it
expanded (:func:`mla_prefill`: the latent lifted by ``wkv_b`` to each
head's k_nope and v); decode runs it absorbed (:func:`mla_decode`: q_nope
taken into the latent space through W_UK, scores over the latent row and
the rotary key, the latent output lifted by W_UV).  K2 takes equal q/k/v
head widths, so MLA computes neither form with it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, apply_rope_interleaved, \
    dense_init, head_rms_norm, rms_norm, yarn_inv_freq, yarn_mscale

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


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2, no q LoRA)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, dtype, *, reps, device=None):
    """``wq`` (d, H x (nope + rope)), ``wkv_a`` (d, latent + rope: the
    published ``kv_a_proj_with_mqa``), ``kv_norm`` (the ``kv_a_layernorm``
    over the latent), ``wkv_b`` (latent, H x (nope + v)) and ``wo``."""
    d, H = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)

    def w(shape):
        return dense_init(gen, (reps, *shape), dtype=dtype, device=device)

    return {"wq": w((d, H * (dn + dr))), "wkv_a": w((d, r + dr)),
            "kv_norm": torch.ones((reps, r), dtype=dtype, device=device),
            "wkv_b": w((r, H * (dn + dv))), "wo": w((H * dv, d))}


def mla_row_width(cfg) -> int:
    """Values a token stores a layer: the latent and the rotary key."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def mla_softmax_scale(cfg) -> float:
    """``(nope + rope)^-0.5``, times YaRN's ``mscale(factor,
    mscale_all_dim)`` squared."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    m = yarn_mscale(cfg.rope_yarn_factor, cfg.rope_yarn_mscale_all_dim)
    return scale * m * m


def _mla_project(p, x, cfg, positions):
    """(q_nope (B,S,H,nope), q_pe (B,S,H,rope), row (B,S,latent + rope)):
    the query, and the cache row of each token: its normed latent and its
    rotary key, both turned to ``positions``."""
    B, S, _ = x.shape
    H, r, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, -1)
    ckv = x @ p["wkv_a"]
    inv = yarn_inv_freq(cfg, x.device)
    scale = (yarn_mscale(cfg.rope_yarn_factor, cfg.rope_yarn_mscale)
             / yarn_mscale(cfg.rope_yarn_factor,
                           cfg.rope_yarn_mscale_all_dim))
    q_pe = apply_rope_interleaved(q[..., dn:], positions, inv, scale)
    k_pe = apply_rope_interleaved(ckv[..., None, r:], positions, inv, scale)
    row = torch.cat([rms_norm(ckv[..., :r], p["kv_norm"]), k_pe[:, :, 0]],
                    dim=-1)
    return q[..., :dn], q_pe, row


def mla_causal_attn(q, k, v, scale: float, *, block_q: int = 1024):
    """Causal attention with q/k and v of different head widths, f32
    scores and softmax, over query blocks of ``block_q``.  q, k:
    (B,S,H,dqk); v: (B,S,H,dv)."""
    S = q.shape[1]
    outs = []
    for q0 in range(0, S, block_q):
        q1 = min(S, q0 + block_q)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1].float(),
                         k[:, :q1].float()) * scale
        causal = (torch.arange(q1, device=q.device)[None, :]
                  <= torch.arange(q0, q1, device=q.device)[:, None])
        s = s.masked_fill(~causal, NEG_INF)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                 v[:, :q1].float()))
    return torch.cat(outs, dim=1).to(q.dtype)


def mla_prefill(p, x, cfg, positions, cache=None):
    """The expanded form over a whole sequence: the latent lifted to each
    head's k_nope and v, the rotary key broadcast to every head.  Returns
    (out (B,S,d), new cache entries): with a cache, slots [0, S) of
    ``ckv`` hold the rows."""
    B, S, _ = x.shape
    H, dn = cfg.num_heads, cfg.qk_nope_head_dim
    q_nope, q_pe, row = _mla_project(p, x, cfg, positions)
    r = cfg.kv_lora_rank
    kv = (row[..., :r] @ p["wkv_b"]).reshape(B, S, H, -1)
    k_pe = row[..., None, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    o = mla_causal_attn(q, k, kv[..., dn:], mla_softmax_scale(cfg))
    new = {}
    if cache is not None:
        new["ckv"] = torch.zeros_like(cache["ckv"])
        new["ckv"][:, :S, 0] = row.to(cache["ckv"].dtype)
    return o.reshape(B, S, -1) @ p["wo"], new


def mla_decode(p, x, cfg, pos, cache):
    """The absorbed form of one token a row at ``pos`` (B,): the row is
    written into slot ``pos`` of the cache by a one-hot select (a position
    past the cache is dropped, as a dense cache drops it), q_nope is taken
    into the latent space through W_UK, each head scores the latent rows
    and the rotary keys of slots ``<= pos`` (f32), and its latent output is
    lifted through W_UV.  x: (B,1,d); ``cache["ckv"]``: (B,W,1,latent +
    rope).  Returns (out (B,1,d), {"ckv": the new cache})."""
    B = x.shape[0]
    H, r, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q_nope, q_pe, row = _mla_project(p, x, cfg, pos[:, None])
    old = cache["ckv"]
    W = old.shape[1]
    slots = torch.arange(W, device=pos.device)[None, :]
    hot = slots == pos[:, None]
    ckv = torch.where(hot[:, :, None, None], row[:, :, None].to(old.dtype),
                      old)
    wkv_b = p["wkv_b"].reshape(r, H, -1).float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(),
                         wkv_b[..., :dn])
    q_all = torch.cat([q_lat, q_pe[:, 0].float()], dim=-1)   # (B,H,r+rope)
    rows = ckv[:, :, 0].float()                               # (B,W,r+rope)
    s = torch.einsum("bhc,bwc->bhw", q_all, rows) * mla_softmax_scale(cfg)
    s = s.masked_fill(~(slots <= pos[:, None])[:, None], NEG_INF)
    o_lat = torch.einsum("bhw,bwr->bhr", torch.softmax(s, -1),
                         rows[..., :r])
    o = torch.einsum("bhr,rhv->bhv", o_lat, wkv_b[..., dn:])
    return o.reshape(B, 1, -1).to(x.dtype) @ p["wo"], {"ckv": ckv}
