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

:func:`moe_ffn_dropless` (DeepSeek-V2's routed experts, no counterpart in
the reference) drops nothing: every expert has room for every token routed
to it, so what a token receives does not depend on its batch-mates.  Its
gates are renormalised only under ``norm_topk_prob`` (DeepSeek-V2-Lite's
softmax scores weight the experts as they are); the weighted sum of the
experts is taken in f32, as DeepSeek-V2's ``moe_infer`` takes it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_mlp, dense_init, gelu, \
    init_mlp, silu
from repro_torch.obs import layerspans


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


#: up to this many tokens a call, every expert gets a row for each token
#: (no host read of the counts: the decode step's batch); above it, as
#: many rows as the most any expert received (one host sync: prefill)
DROPLESS_STATIC_TOKENS = 64


def route(p, x, cfg):
    """(probs (T,E) f32, gate (T,k) f32, expert_idx (T,k)) of x: (T, d).
    f32 router logits, softmax scores, the top k by a stable descending
    sort (ties to the lower expert index)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)       # (T,E)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    k = cfg.experts_per_token
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]            # (T,k)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, expert_idx


def _load(probs, flat_e, cfg):
    """(tokens a expert (E,) int64, the Switch/GShard load-balance loss)."""
    T = probs.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    # tokens per expert, as bincount gives them (bincount has no meta
    # kernel, so the dry-run could not trace it; scatter_add_ has one)
    assign = torch.zeros(E, dtype=torch.int64,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    aux = E * torch.sum(probs.mean(0) * assign.float() / (T * k)) \
        * cfg.router_aux_weight
    return assign, aux


def _ranks(flat_e, E: int):
    """Each assignment's place among its expert's, in token order."""
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(flat_e.numel(), device=dev) \
        - seg_start[sorted_e]
    return rank


def _experts(p, buf, cfg):
    """Every expert's MLP over its rows: buf (E, C, d) -> (E, C, d)."""
    if cfg.mlp_type == "swiglu":
        h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = gelu(torch.bmm(buf, p["w_up"]))
    return torch.bmm(h, p["w_down"])


def moe_ffn(p, x, cfg):
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar)."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    dev = x.device

    probs, gate, expert_idx = route(p, x, cfg)
    flat_e = expert_idx.reshape(-1)                              # (T*k,)
    _, aux = _load(probs, flat_e, cfg)

    # ---- sort-based dispatch ----------------------------------------------
    rank = _ranks(flat_e, E)
    keep = rank < C
    slot = torch.where(keep, rank, C)                    # dropped -> pad slot
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    buf[flat_e, slot] = x[tok_idx]
    out_buf = _experts(p, buf[:, :C], cfg)                       # (E,C,d)

    # ---- combine ------------------------------------------------------------
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, d))], dim=1)
    routed = out_buf[flat_e, slot]                               # (T*k,d)
    routed = torch.where(keep[:, None], routed, 0)
    y = (routed.reshape(T, k, d)
         * gate[..., None].to(routed.dtype)).sum(dim=1)
    if "dense_mlp" in p:
        y = y + apply_mlp(p["dense_mlp"], x, cfg.mlp_type)
    return y.to(x.dtype), aux


def moe_ffn_dropless(p, x, cfg):
    """x: (T, d) -> (y: (T, d), aux_loss: f32 scalar), with no token
    dropped: each expert holds C rows, C = T up to
    ``DROPLESS_STATIC_TOKENS`` tokens (a token takes k distinct experts, so
    no expert receives more), else the most any expert received.  The
    shared experts (``dense_mlp``) are added for every token.  The call's
    routing goes to the running step's marks (``obs/layerspans.py::
    routing``) as it stands on the device (:func:`routing_counts` reads it
    on the host): the tokens routed, the tokens each expert received, each
    assignment's rank among its expert's, and the rows an expert holds."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = x.device
    probs, gate, expert_idx = route(p, x, cfg)
    flat_e = expert_idx.reshape(-1)                              # (T*k,)
    assign, aux = _load(probs, flat_e, cfg)
    rank = _ranks(flat_e, E)
    C = T if T <= DROPLESS_STATIC_TOKENS else int(assign.max())
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    buf = x.new_zeros((E, C, d))
    buf[flat_e, rank] = x[tok_idx]
    routed = _experts(p, buf, cfg)[flat_e, rank].reshape(T, k, d)
    y = (routed.float() * gate[..., None]).sum(dim=1).to(x.dtype)
    if "dense_mlp" in p:
        y = y + apply_mlp(p["dense_mlp"], x, cfg.mlp_type)
    layerspans.routing(tokens=T, assign=assign, rank=rank, capacity=C)
    return y, aux


def routing_counts(tokens, assign, rank, capacity) -> dict:
    """A dropless MoE call's routing on the host: tokens routed, the most
    any one expert received, the experts touched, and the assignments
    dropped (0)."""
    return dict(tokens=tokens, max_per_expert=int(assign.max()),
                experts_touched=int((assign > 0).sum()),
                dropped=int((rank >= capacity).sum()))
