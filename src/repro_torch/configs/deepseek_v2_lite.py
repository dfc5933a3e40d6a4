"""DeepSeek-V2-Lite — 15.7B MoE with multi-head latent attention: 27 MLA
layers (no q LoRA), the first with a dense SwiGLU MLP, the other 26 with
64 routed experts (softmax top-6, unnormalised) and 2 shared
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,         # MLA: every head reads the one latent row
    d_ff=1408,               # per routed expert (moe_intermediate_size)
    vocab_size=102400,
    attention="full",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    num_experts=64,
    experts_per_token=6,
    moe_dense_ff=2816,       # the 2 shared experts as one MLP of 2 x 1408
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_yarn_factor=40.0,
    rope_yarn_original=4096,
    rope_yarn_beta_fast=32.0,
    rope_yarn_beta_slow=1.0,
    rope_yarn_mscale=0.707,
    rope_yarn_mscale_all_dim=0.707,
    norm_topk_prob=False,    # softmax scores, routed_scaling_factor 1
    first_k_dense=1,
    first_dense_ff=10944,    # intermediate_size of the dense first layer
    source="hf:deepseek-ai/DeepSeek-V2-Lite (MLA kv_lora 512, 64e top-6 "
           "+ 2 shared, first layer dense)",
)
