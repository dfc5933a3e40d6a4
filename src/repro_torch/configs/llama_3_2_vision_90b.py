"""Llama-3.2-Vision-90B backbone — decoder with interleaved cross-attention
image layers; ViT frontend is a STUB supplying patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,          # 80 self-attn + 20 cross-attn (every 5th)
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,          # GQA
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    image_tokens=1601,       # ViT stub output (1 tile of 1601 patch embeddings)
    attention="full",
    mlp_type="swiglu",
    rope_theta=500_000.0,
    optimizer="adafactor",   # 90B: AdamW fp32 state does not fit a v5e pod
    source="hf:meta-llama/Llama-3.2-11B-Vision (cross-attn image layers)",
)
