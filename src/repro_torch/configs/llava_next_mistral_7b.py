"""llava-next-mistral-7b [vlm]: 32L d=4096 32H (kv=8) ff=14336 vocab=32000.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — Mistral-7B backbone;
anyres tiling vision frontend STUBBED: input_specs supplies precomputed
patch embeddings (B, 576, 1024) which an MLP projector maps into the LM
sequence ahead of the text tokens.
"""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava_next_mistral_7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    vlm=VLMConfig(n_patches=576, d_vision=1024),
)

SMOKE = ModelConfig(
    name="llava_next_mistral_7b_smoke",
    family="vlm",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=344,
    vocab_size=512,
    vlm=VLMConfig(n_patches=16, d_vision=48),
    attn_impl="full",
)
