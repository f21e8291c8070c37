"""Frozen work arithmetic of the serving cells: operations and bytes from a
configuration's shapes, never from the program's own counts.

Peaks are one NVIDIA H100 SXM's published dense rates at its 700 W limit.
A matrix product of (m, k) by (k, n) counts 2·m·k·n operations.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def _hd(mc: dict) -> int:
    return mc.get("head_dim") or mc["d_model"] // mc["n_heads"]


def param_count(mc: dict) -> int:
    """Every weight: embedding, per layer norms + attention + MLP or router
    and experts, final norm, untied head."""
    d, h, hk, hd, v = mc["d_model"], mc["n_heads"], mc["n_kv_heads"], _hd(mc), mc["vocab_size"]
    layer = 2 * d + d * h * hd * 2 + 2 * d * hk * hd
    moe = mc.get("moe")
    if moe:
        layer += d * moe["n_experts"] + moe["n_experts"] * 3 * d * moe["d_expert"]
    else:
        layer += 3 * d * mc["d_ff"]
    head = 0 if mc.get("tie_embeddings") else v * d
    return v * d + mc["n_layers"] * layer + d + head


def token_linear_flops(mc: dict) -> int:
    """Operations of one token through every layer's linear maps (attention
    projections, MLP or router + its top-k experts), without attention
    scores and without the output head."""
    d, h, hk, hd = mc["d_model"], mc["n_heads"], mc["n_kv_heads"], _hd(mc)
    per = 2 * (d * h * hd * 2 + 2 * d * hk * hd)
    moe = mc.get("moe")
    if moe:
        per += 2 * d * moe["n_experts"] + moe["top_k"] * 3 * 2 * d * moe["d_expert"]
    else:
        per += 3 * 2 * d * mc["d_ff"]
    return mc["n_layers"] * per


def head_flops(mc: dict) -> int:
    return 2 * mc["d_model"] * mc["vocab_size"]


def first_token_flops(mc: dict, prompt_len: int) -> int:
    """What a request's first token needs: every layer over its real prompt
    tokens, causal attention over the prompt's own length (half of the
    4·H·L²·hd of the full square), the head at the last position only."""
    attn = mc["n_layers"] * 2 * mc["n_heads"] * _hd(mc) * prompt_len * prompt_len
    return token_linear_flops(mc) * prompt_len + attn + head_flops(mc)


def decode_step_work(mc: dict, contexts: list[int]) -> tuple[float, float]:
    """(operations, bytes) of one decode step for rows whose real context
    before the new token is ``contexts``: the weights read once in bf16, each
    row's real keys and values read once and the new ones written."""
    hd, h, hk, layers = _hd(mc), mc["n_heads"], mc["n_kv_heads"], mc["n_layers"]
    flops = 0
    kv_entries = 0
    for c in contexts:
        flops += token_linear_flops(mc) + head_flops(mc) + layers * 4 * h * hd * (c + 1)
        kv_entries += c + 1
    kv_bytes = kv_entries * layers * 2 * hk * hd * BF16
    return float(flops), float(param_count(mc) * BF16 + kv_bytes)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_work(bh: int, t: int, hd: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one causal attention call over (BH, T, hd):
    half of 4·BH·T²·hd, and q, k, v read and o written once."""
    return 2.0 * bh * t * t * hd, 4.0 * bh * t * hd * itemsize
