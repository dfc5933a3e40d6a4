"""Qwen3-4B — dense GQA decoder with per-head q/k RMS-norm
[hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,          # GQA
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,            # qwen3 decouples head_dim from d_model/num_heads
    qk_norm=True,
    attention="full",
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (qk_norm, GQA)",
)
