"""Whisper-medium — encoder-decoder audio backbone; the mel+conv frontend is a
STUB supplying precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,           # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,         # MHA (GQA kv=16 == heads)
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=24,
    encoder_seq=1500,        # 30 s audio -> 1500 frame embeddings (conv stub)
    attention="full",
    mlp_type="gelu",
    source="arXiv:2212.04356 (Whisper; enc-dec, conv frontend stubbed)",
)
