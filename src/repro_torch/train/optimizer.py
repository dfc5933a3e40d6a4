"""Optimizers (counterpart of ``repro/train/optimizer.py``): AdamW and
Adafactor (factored second moment over the last two axes, with update
clipping), the warmup-cosine LR schedule and the global-norm clip.

The arithmetic is the reference's, in f32 whatever the parameter dtype,
with two differences of form:

- the clip casts one gradient leaf to f32 at a time (in the norm, then in
  its update), so the f32 copy of the whole gradient tree never exists,
  where the reference maps the cast over the tree;
- :func:`update` writes the new parameters and moments into the tensors
  it was given and returns them (the reference returns new trees), so a
  step holds one copy of the optimizer state.  Pass clones to keep the
  old values.

The step counter and the schedule's scalars (lr, bias corrections, the
Adafactor decay) are 0-d CPU tensors, which PyTorch takes as scalars
beside tensors on the card, so reading the lr makes no device sync.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    eps2: float = 1e-30


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(device="cpu", dtype=torch.float32)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; a 0-d f32 CPU
    tensor."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum of
    squares."""
    parts = [torch.sum(torch.square(x.float()))
             for x in tree_mod.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(parts)))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(f32 grads scaled to a global norm of at most ``max_norm``, norm).
    Builds the whole f32 tree: the updates below scale leaf by leaf
    instead."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_mod.map_leaves(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": tree_mod.map_leaves(zeros, params),
            "v": tree_mod.map_leaves(zeros, params)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, _f32(step))
    bc2 = 1 - torch.pow(b2, _f32(step))
    for p, g, m, v in zip(*(tree_mod.leaves(t) for t in
                            (params, grads, state["m"], state["v"]))):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        u = u + cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": norm}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored for ndim>=2 over last two dims
# ---------------------------------------------------------------------------


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params):
    def st(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"step": torch.zeros((), dtype=torch.int32),
            "v": tree_mod.map_leaves(st, params)}


def _param_states(params, v):
    """Each parameter leaf's state dict, in JAX's order of the params."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in _param_states(params[k], v[k])]
    if isinstance(params, (list, tuple)):
        return [s for pk, vk in zip(params, v)
                for s in _param_states(pk, vk)]
    return [v]


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    beta2 = 1.0 - torch.pow(_f32(step) + 1.0, -cfg.decay_rate)
    for p, g, st in zip(tree_mod.leaves(params), tree_mod.leaves(grads),
                        _param_states(params, state["v"])):
        g = g.float() * scale
        g2 = g * g + cfg.eps2
        if _factored(p):
            st["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(-1))
            st["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(-2))
            denom = st["vr"].mean(-1, keepdim=True)
            rfac = torch.rsqrt(st["vr"] / torch.clamp(denom, min=cfg.eps2))
            cfac = torch.rsqrt(st["vc"])
            u = g * rfac[..., None] * cfac[..., None, :]
        else:
            st["v"].mul_(beta2).add_((1 - beta2) * g2)
            u = g * torch.rsqrt(st["v"])
        del g2
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        p32 = p.float()
        u = u + cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": norm}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def init(name: str, params):
    return adamw_init(params) if name == "adamw" else adafactor_init(params)


def update(name: str, params, grads, state, cfg: OptConfig):
    if name == "adamw":
        return adamw_update(params, grads, state, cfg)
    return adafactor_update(params, grads, state, cfg)
