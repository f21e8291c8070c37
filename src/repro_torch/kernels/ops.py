"""Model-facing wrappers over the port's kernels.

``flash_attention`` takes the models' (B, H, T, hd) layout, as the JAX
package's ``ops.flash_attention`` does, and hands (B*H, T, hd) to the kernel
wrapper, which launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor.  The models route here when
``cfg.attn_impl == "pallas"``.  The decode-attention and SSD-scan entry
points come with their kernels (ROADMAP Queue 2).
"""
from __future__ import annotations

from .flash_attention import flash_attention_bhtd


def flash_attention(q, k, v, *, q_pos=None, k_pos=None, window=None, scale):
    """(B,H,T,hd) attention; positions must be contiguous from 0."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    out = flash_attention_bhtd(
        q.reshape(b * h, t, hd),
        k.reshape(b * h, s, hd),
        v.reshape(b * h, s, hd),
        scale=scale,
        window=window,
    )
    return out.reshape(b, h, t, hd)
