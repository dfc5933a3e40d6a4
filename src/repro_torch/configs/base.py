"""Architecture and input-shape configuration registry (counterpart of
``repro/configs/base.py``).

Every architecture is a frozen :class:`ArchConfig`; the four input shapes
are :class:`ShapeSpec` entries in ``SHAPES``.  ``input_specs`` and
``cache_specs`` build ``meta`` tensors of the reference's
``ShapeDtypeStruct`` stand-ins for the dry-run (no allocation), and
``reduced`` derives the small CPU-test variant of the same family.  All ten
configurations are registered, in the reference's order, and after them
the port's own (``PORT_ARCH_NAMES``: deepseek-v2-lite, whose latent
attention and DeepSeek routing the reference has no counterpart of).
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

    # --- latent attention (MLA) and DeepSeek routing ------------------------
    kv_lora_rank: int = 0            # > 0: every layer attends by MLA
    qk_nope_head_dim: int = 0        # per-head q/k width without rotary
    qk_rope_head_dim: int = 0        # q/k rotary width (one shared k_pe)
    v_head_dim: int = 0
    rope_yarn_factor: float = 1.0    # > 1: YaRN-scaled rotary frequencies
    rope_yarn_original: int = 4096   # original_max_position_embeddings
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_mscale: float = 1.0
    rope_yarn_mscale_all_dim: float = 1.0
    norm_topk_prob: bool = True      # renormalise the top-k gates to 1
    first_k_dense: int = 0           # leading MLA layers with a dense MLP
    first_dense_ff: int = 0          # ... of this width

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

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context (skip rule for
        long_500k)?"""
        return self.family in ("ssm", "hybrid") or self.attention == "swa"

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # -- parameter counting (for MODEL_FLOPS = 6 N D), the reference's ------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.hd
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        dense_mlp = mlp_mult * d * ff if ff else 0
        total = 0
        shared_attn_counted = False
        mla = 0
        if self.kv_lora_rank:
            r, dr = self.kv_lora_rank, self.qk_rope_head_dim
            mla = (d * nq * (self.qk_nope_head_dim + dr) + d * (r + dr)
                   + r * nq * (self.qk_nope_head_dim + self.v_head_dim)
                   + nq * self.v_head_dim * d)
        for kind in layer_kinds(self):
            if kind == "mla":
                total += mla + mlp_mult * d * self.first_dense_ff
            elif kind == "mla_moe":
                e = self.experts_per_token if active_only else \
                    self.num_experts
                total += (mla + e * mlp_mult * d * ff + d * self.num_experts
                          + mlp_mult * d * self.moe_dense_ff)
            elif kind == "attn":
                total += attn + dense_mlp
            elif kind == "moe":
                e = self.experts_per_token if active_only else \
                    self.num_experts
                total += attn + e * mlp_mult * d * ff
                if self.moe_dense_ff:
                    total += mlp_mult * d * self.moe_dense_ff
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                total += 2 * d * d_in + d_in * d + d_in * self.ssm_conv
            elif kind == "mlstm":
                d_in = 2 * d
                total += 2 * d * d_in + d_in * d + 3 * d_in * hd
            elif kind == "slstm":
                total += 4 * d * d + 2 * d * (4 * d // 3)
            elif kind == "shared_attn":
                if not shared_attn_counted:
                    total += attn + dense_mlp
                    shared_attn_counted = True
            elif kind == "cross":
                total += attn + dense_mlp
            elif kind == "encdec":
                total += 2 * attn + dense_mlp  # self + cross attention, mlp
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += self.encoder_layers * (attn + dense_mlp)
        return int(total)


def layer_kinds(cfg: ArchConfig) -> list:
    """Per-layer block kinds for the decoder stack.  Under latent attention
    the first ``first_k_dense`` layers are ``mla`` (a dense MLP) and the
    rest ``mla_moe`` (routed and shared experts)."""
    if cfg.kv_lora_rank:
        k = cfg.first_k_dense
        return ["mla"] * k + ["mla_moe"] * (cfg.num_layers - k)
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


# ---------------------------------------------------------------------------
# Input shapes, and meta stand-ins for the dry-run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def _meta(shape, dtype) -> torch.Tensor:
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    return torch.empty(tuple(int(s) for s in shape), dtype=dt, device="meta")


def frontend_specs(cfg: ArchConfig, batch: int) -> dict:
    """Stubbed modality-frontend embeddings (the one allowed stub)."""
    out = {}
    if cfg.family == "audio":
        out["audio_embeds"] = _meta((batch, cfg.encoder_seq, cfg.d_model),
                                    cfg.dtype)
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((batch, cfg.image_tokens, cfg.d_model),
                                    cfg.dtype)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins for every model input of this step kind."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
        specs.update(frontend_specs(cfg, b))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), torch.int32)}
        specs.update(frontend_specs(cfg, b))
        return specs
    # decode: ONE new token against a seq_len-deep cache; the frontends are
    # consumed at prefill (their K/V live in the cache)
    return {"token": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32),
            "cache": cache_specs(cfg, b, s)}


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """Meta tensors matching ``models.kvcache.init_cache``."""
    from repro_torch.models import kvcache   # local: keep configs light
    return kvcache.cache_struct(cfg, batch, seq_len)


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

#: configurations of the port alone (no counterpart in the reference)
PORT_ARCH_NAMES = [
    "deepseek_v2_lite",
]

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES + PORT_ARCH_NAMES}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    known = ARCH_NAMES + PORT_ARCH_NAMES
    if key not in known:
        raise KeyError(f"unknown arch {name!r}; known: {known}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def all_configs() -> dict:
    return {n: get_config(n) for n in ARCH_NAMES}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """<=2-ish layers (one repeat unit), d_model<=512, <=4 experts, small
    vocab — the same rule as the reference, so both packages build the same
    reduced model.  Under latent attention: the leading dense layers and two
    after them, MLA widths cut alike (no reference counterpart)."""
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
    if cfg.kv_lora_rank:
        changes.update(num_layers=cfg.first_k_dense + 2,
                       kv_lora_rank=min(cfg.kv_lora_rank, 64),
                       qk_nope_head_dim=min(cfg.qk_nope_head_dim, 32),
                       qk_rope_head_dim=min(cfg.qk_rope_head_dim, 16),
                       v_head_dim=min(cfg.v_head_dim, 32),
                       first_dense_ff=min(cfg.first_dense_ff, 512))
    return dataclasses.replace(cfg, **changes)
