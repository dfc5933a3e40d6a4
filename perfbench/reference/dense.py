"""Dense GQA decoder (qwen3-4b): embedding, per layer pre-norm attention
with per-head q/k RMS norm and rotary positions, then SwiGLU; final norm
and the LM head (the embedding's transpose when tied)."""
from __future__ import annotations

import torch

from perfbench.reference import common


def logits(params, a: dict, tokens: torch.Tensor, rows, w=common.f32_weight):
    """Float32 logits at positions ``rows`` of the sequence ``tokens``
    ((S,) int64), which attends causally over itself."""
    x = w(params["embed"])[tokens]
    blocks = params["blocks"][0]
    for r in range(a["num_layers"]):
        x = common.attn_block(common.layer(blocks, r), x, a, w)
    return common.head(params, x, a, w, rows)
