"""Architecture configuration registry (counterpart of ``repro/configs/base.py``).

Every architecture is a frozen :class:`ArchConfig`; ``reduced`` derives the
small CPU-test variant of the same family.  All ten configurations are
registered, in the reference's order; the dry-run ``ShapeDtypeStruct``
stand-ins of the reference are not ported (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    source: str = ""

    # --- attention options -------------------------------------------------
    attention: str = "full"          # full | swa
    window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mlp_type: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False

    # --- MoE / SSM / enc-dec / vlm (read by layer_kinds and reduced) --------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    ssm_state: int = 0               # Mamba2 state dim per head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv: int = 4                # local conv width
    hybrid_period: int = 0           # zamba2: every Nth layer is shared attn
    xlstm_pattern: tuple = ()
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attn_every: int = 0
    image_tokens: int = 0

    # --- numerics / training ------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor (read by training)
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def layer_kinds(cfg: ArchConfig) -> list:
    """Per-layer block kinds for the decoder stack."""
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "audio":
        return ["encdec"] * cfg.num_layers
    if cfg.family == "ssm" and cfg.xlstm_pattern:
        pat = list(cfg.xlstm_pattern)
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        per = cfg.hybrid_period or 6
        return ["shared_attn" if (i % per == per - 1) else "mamba"
                for i in range(cfg.num_layers)]
    if cfg.family == "vlm" and cfg.cross_attn_every:
        per = cfg.cross_attn_every
        return ["cross" if (i % per == per - 1) else "attn"
                for i in range(cfg.num_layers)]
    return ["attn"] * cfg.num_layers


def repeat_unit(cfg: ArchConfig):
    """(unit_kinds, n_repeats) such that unit * n == layer_kinds."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for ulen in range(1, n + 1):
        if n % ulen:
            continue
        unit = kinds[:ulen]
        if unit * (n // ulen) == kinds:
            return tuple(unit), n // ulen
    return tuple(kinds), 1


ARCH_NAMES = [
    "minitron_8b",
    "h2o_danube_3_4b",
    "starcoder2_7b",
    "llama4_scout_17b_a16e",
    "arctic_480b",
    "xlstm_125m",
    "whisper_medium",
    "zamba2_2_7b",
    "llama_3_2_vision_90b",
    "qwen3_4b",
]

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """<=2-ish layers (one repeat unit), d_model<=512, <=4 experts, small
    vocab — the same rule as the reference, so both packages build the same
    reduced model."""
    unit, _ = repeat_unit(cfg)
    layers = len(unit) if len(unit) > 1 else 2
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        num_layers=layers,
        d_model=256,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=0 if cfg.d_ff == 0 else 512,
        vocab_size=512,
        window=64,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32),
        image_tokens=min(cfg.image_tokens, 16) if cfg.image_tokens else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=(min(cfg.experts_per_token, 2)
                           if cfg.experts_per_token else 0),
        moe_dense_ff=256 if cfg.moe_dense_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    return dataclasses.replace(cfg, **changes)
