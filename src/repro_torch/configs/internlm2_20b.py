"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) ff=16384 vocab=92544.

[arXiv:2403.17297; hf] — RMSNorm, SwiGLU, GQA.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2_20b_smoke",
    family="dense",
    n_layers=3,
    d_model=192,
    n_heads=6,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attn_impl="full",
)
