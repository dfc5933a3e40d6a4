"""The model FLOP count of one decoder layer, one file a layer kind.

``perfbench/work/<kind>.py`` holds the formulas of the layer kind that
``configs/base.py::layer_kinds`` names ``<kind>`` in the port: two
functions of the configuration file's ``arch`` alone,

- ``token_flops(a)``: the forward FLOPs of one token through the layer's
  matmul parameters, and through its recurrent state where it has one;
- ``context_flops(a)``: the FLOPs of one token per visible position of
  its context (0 for a layer with no attention over a cache).

Each file copies its shapes from the port function it names, as the port
has it at commit 4136c98 (``src/repro_torch/models``), and imports
nothing of the program, so its readings stay frozen when the program
changes.  A configuration of a new layer kind adds a file here; no file
changes.
"""
from __future__ import annotations

import importlib


def formula(kind: str):
    """The module of layer kind ``kind``; raises, naming the file to add,
    where there is none."""
    name = f"{__name__}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(
            f"no FLOP count for layer kind {kind!r}: add "
            f"perfbench/work/{kind}.py with token_flops(a) and "
            f"context_flops(a)") from None


def head_dim(a: dict) -> int:
    """``ArchConfig.hd``."""
    return a.get("head_dim") or a["d_model"] // a["num_heads"]


def attn_params(a: dict) -> int:
    """The Q, K, V and O projections of ``models/attention.py::init_attn``
    (q_norm and k_norm are scalings, not products)."""
    d, nq, nkv, hd = a["d_model"], a["num_heads"], a["num_kv_heads"], \
        head_dim(a)
    return d * nq * hd + 2 * d * nkv * hd + nq * hd * d


def mlp_params(a: dict, f: int) -> int:
    """``models/layers.py::init_mlp`` of width ``f``: gate, up and down
    under SwiGLU, up and down otherwise; nothing where ``f`` is 0."""
    if not f:
        return 0
    return (3 if a["mlp_type"] == "swiglu" else 2) * a["d_model"] * f


def attention_context_flops(a: dict) -> float:
    """QK^T and PV of one query head row against one visible position, over
    every query head: 2 products of ``hd`` multiply-adds each."""
    return 4.0 * a["num_heads"] * head_dim(a)
