"""deepseek-7b [dense]: 30L d=4096 32H (kv=32 i.e. MHA) ff=11008 vocab=102400.

llama-arch [arXiv:2401.02954; hf] — RMSNorm, SwiGLU, full rotary.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek_7b_smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=344,
    vocab_size=512,
    attn_impl="full",
)
