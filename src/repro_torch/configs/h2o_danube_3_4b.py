"""H2O-Danube3-4B — llama+mistral-style dense LM with sliding-window attention
[arXiv:2401.16818 (danube series)]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,          # GQA
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    attention="swa",         # mistral-style sliding window
    window=4096,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.16818 (H2O-Danube; llama/mistral mix, SWA)",
)
