"""Quantized-communication helpers (gradient/weight compression).

The device-side analogue of FaaSNet's block compression (§3.5): trade cheap
elementwise compute for scarce interconnect bandwidth.  Row-wise symmetric
int8 with an f32 scale per row — 2× wire reduction on bf16 payloads at
~1e-2 relative error, which is ample for weight broadcast and for
error-feedback-compensated gradient all-reduce.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so payloads and scales equal the JAX
package's.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., n) -> (int8 (..., n), f32 scale (...,))."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def compress_error_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback int8 compression for gradient all-reduce.

    Returns (dequantized payload, new residual).  The caller all-reduces the
    payload; the quantization error is fed back into the next step,
    preserving convergence (Karimireddy et al., 2019).
    """
    target = grad + residual
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale).to(grad.dtype)
    return deq, target - deq
