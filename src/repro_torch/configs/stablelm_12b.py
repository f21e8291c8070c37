"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-12b family; hf] — LayerNorm + partial rotary
(25 %), untied embeddings, qk-norm per StableLM-2 12B.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    norm="layernorm",
    act="swiglu",
    qk_norm=True,
    rope_pct=0.25,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="stablelm_12b_smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=344,
    vocab_size=512,
    norm="layernorm",
    act="swiglu",
    qk_norm=True,
    rope_pct=0.25,
    attn_impl="full",
)
