"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

GShard-style capacity, Megablox-style sort routing: no ``(T, E, C)``
one-hot dispatch tensor.  Top-k routing (k=1 llama4-scout, k=2 arctic) and
an optional parallel dense MLP (arctic's dense residual, llama4's shared
expert).  The reference computes all of it outside any Pallas kernel, so
the expert products stay ``torch.bmm``.

Where the two libraries could part:

- top-k: a stable descending sort, so equal probabilities go to the lower
  expert index, as ``jax.lax.top_k`` breaks ties;
- the dispatch order: ``argsort(stable=True)``, as ``jnp.argsort`` is
  stable, and ``searchsorted`` on the left side, its default in both;
- a dropped token is written to the pad slot ``C`` (which is discarded)
  and masked out of the combine.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_mlp, dense_init, gelu, \
    init_mlp, silu


def init_moe(gen, cfg, dtype, *, reps, device=None):
    """Router (f32), expert stacks ``(reps, E, ...)`` and the optional
    dense MLP, with the reference's key names."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(shape, **kw):
        return dense_init(gen, (reps, *shape), device=device, **kw)

    p = {"router": w((d, e), scale=d ** -0.5, dtype=torch.float32),
         "w_gate": w((e, d, ff), dtype=dtype),
         "w_up": w((e, d, ff), dtype=dtype),
         "w_down": w((e, ff, d), dtype=dtype)}
    if cfg.moe_dense_ff:
        p["dense_mlp"] = init_mlp(gen, d, cfg.moe_dense_ff, cfg.mlp_type,
                                  dtype, reps=reps, device=device)
    return p


def capacity(cfg, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_ffn(p, x, cfg):
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar)."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    dev = x.device

    probs = torch.softmax(x.float() @ p["router"], dim=-1)       # (T,E)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]            # (T,k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- load-balance auxiliary loss (Switch/GShard form) ----------------
    flat_e = expert_idx.reshape(-1)                              # (T*k,)
    # tokens per expert, as bincount gives them (bincount has no meta
    # kernel, so the dry-run could not trace it; scatter_add_ has one)
    assign = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)).float()
    aux = E * torch.sum(probs.mean(0) * assign / (T * k)) \
        * cfg.router_aux_weight

    # ---- sort-based dispatch ----------------------------------------------
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = rank < C
    slot = torch.where(keep, rank, C)                    # dropped -> pad slot
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    buf[flat_e, slot] = x[tok_idx]
    buf = buf[:, :C]                                             # (E,C,d)

    # ---- expert computation -------------------------------------------------
    if cfg.mlp_type == "swiglu":
        h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = gelu(torch.bmm(buf, p["w_up"]))
    out_buf = torch.bmm(h, p["w_down"])                          # (E,C,d)

    # ---- combine ------------------------------------------------------------
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, d))], dim=1)
    routed = out_buf[flat_e, slot]                               # (T*k,d)
    routed = torch.where(keep[:, None], routed, 0)
    y = (routed.reshape(T, k, d)
         * gate[..., None].to(routed.dtype)).sum(dim=1)
    if "dense_mlp" in p:
        y = y + apply_mlp(p["dense_mlp"], x, cfg.mlp_type)
    return y.to(x.dtype), aux
