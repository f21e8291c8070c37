"""Frozen work arithmetic of the hybrid (Mamba2 + attention + MoE) serving
cells: a request's first-token operations from a configuration's shapes,
never from the program's own counts.  ``flops.py``'s conventions: a matrix
product of (m, k) by (k, n) counts 2·m·k·n operations, and the peak is the
one there.

Layer ``i`` is attention where ``i % attn_every == attn_offset`` and Mamba2
elsewhere; every layer has the MoE (router, top-k experts, the shared
expert of ``d_expert · n_shared``).
"""
from __future__ import annotations


def _hd(mc: dict) -> int:
    return mc.get("head_dim") or mc["d_model"] // mc["n_heads"]


def layer_counts(mc: dict) -> tuple[int, int]:
    """(attention layers, Mamba2 layers)."""
    every, off = mc["attn_every"], mc["attn_offset"]
    attn = sum(1 for i in range(mc["n_layers"]) if every and i % every == off)
    return attn, mc["n_layers"] - attn


def token_linear_flops(mc: dict) -> int:
    """Operations of one token through every layer's linear maps: the
    attention or Mamba2 projections, the router, the top-k experts and the
    shared expert; no scores, no SSD, no head."""
    d, h, hk, hd = mc["d_model"], mc["n_heads"], mc["n_kv_heads"], _hd(mc)
    s, moe = mc["ssm"], mc["moe"]
    hp, gn = s["n_heads"] * s["head_dim"], s.get("n_groups", 1) * s["d_state"]
    attn = 2 * (d * h * hd * 2 + 2 * d * hk * hd)
    mamba = 2 * d * (2 * hp + 2 * gn + s["n_heads"]) + 2 * hp * d
    ffn = 2 * d * moe["n_experts"] + 3 * 2 * d * moe["d_expert"] * (
        moe["top_k"] + moe.get("n_shared", 0))
    n_attn, n_mamba = layer_counts(mc)
    return n_attn * attn + n_mamba * mamba + mc["n_layers"] * ffn


def ssd_flops(mc: dict, length: int) -> int:
    """One Mamba2 layer's SSD over ``length`` tokens in chunks of the
    configuration's ``chunk``: per chunk of q tokens the lower triangles of
    C·Bᵀ (q²·N) and of the masked scores times dt·x (q²·P), halved, per head;
    and per token the chunk state's B·(dt·x) and the output's C·state
    (2·P·N each)."""
    s = mc["ssm"]
    q, p, n, heads = s["chunk"], s["head_dim"], s["d_state"], s["n_heads"]
    full, rest = divmod(length, q)
    tri = full * q * q + rest * rest
    return heads * (tri * (n + p) + 4 * length * p * n)


def head_flops(mc: dict) -> int:
    return 2 * mc["d_model"] * mc["vocab_size"]


def first_token_flops(mc: dict, prompt_len: int) -> int:
    """What a request's first token needs: every layer over its real prompt
    tokens, the SSD of each Mamba2 layer at the chunk, NoPE attention over
    half the causal square (half of 4·H·L²·hd), the head at the last
    position only."""
    n_attn, n_mamba = layer_counts(mc)
    attn = n_attn * 2 * mc["n_heads"] * _hd(mc) * prompt_len * prompt_len
    return (token_linear_flops(mc) * prompt_len + n_mamba * ssd_flops(mc, prompt_len)
            + attn + head_flops(mc))
