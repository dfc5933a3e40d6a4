"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    attention="full",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2407.14679 (Minitron: compact LMs via pruning+distillation)",
)
