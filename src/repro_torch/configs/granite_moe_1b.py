"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (kv=8) ff_expert=512 vocab=49155.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — 32 experts top-8, every
layer MoE, RMSNorm, SwiGLU, tied embeddings.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite_moe_1b",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
)

SMOKE = ModelConfig(
    name="granite_moe_1b_smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=4, d_expert=64),
    attn_impl="full",
)
