"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (kv=8) ff=14336, MoE 16e top-2.

[arXiv:2403.19887; hf] — Mamba:attention 7:1 interleave (1 attention layer
per block of 8, at in-block index 4), MoE every other layer (16 experts,
top-2), RMSNorm.  The mamba sublayers are modeled with the SSD form
(d_state 16, headdim 64 → 128 heads); see DESIGN.md hardware-adaptation
notes.  Attention layers use no RoPE in Jamba; we keep RoPE off-pattern
cost-free by retaining it (structural dry-run parity) — noted deviation.
"""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, moe_every=2, moe_offset=1),
    ssm=SSMConfig(n_heads=128, head_dim=64, d_state=16, n_groups=1),
)

SMOKE = ModelConfig(
    name="jamba_v01_52b_smoke",
    family="hybrid",
    n_layers=8,  # one full block: 1 attn + 7 mamba, 4 MoE
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=256, moe_every=2, moe_offset=1),
    ssm=SSMConfig(n_heads=4, head_dim=32, d_state=8, n_groups=1),
    attn_impl="full",
)
