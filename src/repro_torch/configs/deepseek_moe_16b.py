"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) ff_expert=1408 vocab=102400.

[arXiv:2401.06066; hf] — fine-grained MoE: 64 routed experts top-6 + 2
shared experts (d_expert 1408); first layer uses a dense MLP (d_ff 10944).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense first layer
    vocab_size=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_expert=1408, n_shared=2, moe_first_dense=1
    ),
)

SMOKE = ModelConfig(
    name="deepseek_moe_16b_smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=2, moe_first_dense=1),
    attn_impl="full",
)
