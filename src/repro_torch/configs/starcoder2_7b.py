"""StarCoder2-7B — code LM with GQA + RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,          # GQA kv=4
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    attention="full",
    mlp_type="gelu",         # starcoder2 uses non-gated gelu MLP
    rope_theta=100_000.0,
    source="arXiv:2402.19173 (StarCoder2; GQA, RoPE)",
)
