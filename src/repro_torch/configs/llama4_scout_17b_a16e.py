"""Llama-4-Scout-17B-16E — MoE decoder, 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,          # GQA
    d_ff=8192,               # per-expert FFN
    vocab_size=202048,
    head_dim=128,
    attention="full",
    mlp_type="swiglu",
    num_experts=16,
    experts_per_token=1,     # top-1 routing
    moe_dense_ff=8192,       # llama4 has a shared expert alongside routed ones
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (MoE 16e top-1, early fusion)",
)
