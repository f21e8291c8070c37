"""whisper-medium [audio]: 24L d=1024 16H (kv=16) ff=4096 vocab=51865.

[arXiv:2212.04356; unverified] — enc-dec (24 encoder + 24 decoder layers),
conv frontend STUBBED: input_specs feeds precomputed frame embeddings
(B, 1500, 80→d_frontend).  LayerNorm + GELU + attention biases per Whisper.
"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    family="audio",
    n_layers=24,  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, encoder_ctx=1500, d_frontend=1024),
)

SMOKE = ModelConfig(
    name="whisper_medium_smoke",
    family="audio",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=384,
    norm="layernorm",
    act="gelu",
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=2, encoder_ctx=32, d_frontend=48),
    attn_impl="full",
)
