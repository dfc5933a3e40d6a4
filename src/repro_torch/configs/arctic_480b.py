"""Snowflake Arctic — 480B MoE: 128 experts top-2 + parallel dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,          # GQA
    d_ff=4864,               # per-expert FFN
    vocab_size=32000,
    head_dim=128,
    attention="full",
    mlp_type="swiglu",
    num_experts=128,
    experts_per_token=2,     # top-2 routing
    moe_dense_ff=7168,       # dense residual MLP in parallel with the MoE
    rope_theta=10_000.0,
    optimizer="adafactor",   # 480B: AdamW fp32 state does not fit a v5e pod
    source="hf:Snowflake/snowflake-arctic-base (128e top-2 + dense residual)",
)
