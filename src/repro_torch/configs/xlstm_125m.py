"""xLSTM-125M — alternating mLSTM + sLSTM blocks, no FFN (d_ff=0)
[arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                  # xLSTM blocks embed their own projections
    vocab_size=50304,
    head_dim=192,
    xlstm_pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517 (xLSTM: sLSTM + mLSTM blocks)",
)
