"""gemma3-1b [dense]: 26L d=1152 4H (kv=1) ff=6912 vocab=262144.

[hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global sliding window
(512 local), GeGLU, RMSNorm, qk-norm, embeddings scaled by sqrt(d), tied
embeddings, head_dim 256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    sliding_window=512,
    global_every=6,  # 5 local : 1 global
    act="geglu",
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3_1b_smoke",
    family="dense",
    n_layers=8,  # exercises the 5:1 pattern + remainder
    d_model=96,
    n_heads=2,
    n_kv_heads=1,
    head_dim=48,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    global_every=6,
    act="geglu",
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    attn_impl="full",
)
