"""Zamba2-2.7B — hybrid Mamba2 backbone with a shared attention block applied
periodically [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,         # shared attn block is MHA
    d_ff=10240,              # MLP inside the shared attention block
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,            # Mamba2 state per head
    ssm_expand=2,
    hybrid_period=6,         # every 6th layer = the (weight-shared) attn block
    attention="full",        # windowed above 65,536 tokens (ring cache)
    window=4096,
    mlp_type="swiglu",
    source="arXiv:2411.15242 (Zamba2: Mamba2 + shared attention blocks)",
)
