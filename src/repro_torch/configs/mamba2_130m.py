"""mamba2-130m [ssm]: 24L d=768 attention-free, ssm_state=128, vocab=50280.

[arXiv:2405.21060; unverified] — SSD (state-space duality): expand 2 →
d_inner 1536, headdim 64 → 24 heads, 1 group, d_state 128, conv width 4.
No FFN (d_ff = 0): the block IS the mixer. Tied embeddings.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_every=0,  # attention-free
    tie_embeddings=True,
    ssm=SSMConfig(n_heads=24, head_dim=64, d_state=128, n_groups=1),
)

SMOKE = ModelConfig(
    name="mamba2_130m_smoke",
    family="ssm",
    n_layers=3,
    d_model=96,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    attn_every=0,
    tie_embeddings=True,
    ssm=SSMConfig(n_heads=4, head_dim=16, d_state=16, n_groups=1),
)
