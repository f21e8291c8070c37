"""granite-4.0-h-small [hybrid]: 40L d=4096, 36 Mamba2 + 4 NoPE GQA attention
(32H, kv=8, hd 128), every layer MoE 72e top-10 (d_expert 768) + a shared
SwiGLU of 1,536, tied vocab 100,352; 32,207,337,984 parameters.

[hf:ibm-granite/granite-4.0-h-small, config.json, model_type
granitemoehybrid] — attention at ``layer_types`` 5, 15, 25, 35 (every 10th
layer from 5); Mamba2 128 heads x 64 (d_inner 8,192, expand 2), d_state 128,
1 group, conv 4 with a bias, chunk 256, no projection bias; NoPE
(``position_embedding_type`` nope); μP scalars: embeddings x 12, attention
scores x 1/128, each residual branch x 0.22, logits / 16.  The shared
expert is the MoE's ``n_shared`` 2 experts of 768 (one SwiGLU of 1,536).
The SSD's intra-chunk tensors are bf16 (bf16 operands, f32 accumulation
inside a chunk, as the published Mamba2 kernels compute).  Departures, as
every port config has them: the router keeps 1.25 x the even share per
expert (the published router drops nothing), and RMSNorm's epsilon is the
port's 1e-6 (published 1e-5).
"""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="granite4_h_small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    attn_every=10,
    attn_offset=5,
    moe=MoEConfig(n_experts=72, top_k=10, d_expert=768, n_shared=2),
    ssm=SSMConfig(n_heads=128, head_dim=64, d_state=128, n_groups=1, conv_width=4,
                  chunk=256, intra_dtype="bf16", conv_bias=True),
    rope_pct=0.0,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)

SMOKE = ModelConfig(
    name="granite4_h_small_smoke",
    family="hybrid",
    n_layers=10,  # one whole period: 9 Mamba2 + 1 attention (index 5), all MoE
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    attn_every=10,
    attn_offset=5,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=2),
    ssm=SSMConfig(n_heads=16, head_dim=16, d_state=16, n_groups=1, conv_width=4,
                  chunk=16, conv_bias=True),
    rope_pct=0.0,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attn_impl="full",
)
