"""Model-facing wrappers over the port's kernels, as the JAX package's ``ops``.

Each takes the models' layout and hands the kernel wrapper its flattened
(B*H, ...) operands; the wrapper launches the CUDA kernel for a CUDA tensor
and runs the plain version for a CPU tensor.  The models route
``flash_attention`` here when ``cfg.attn_impl == "pallas"``.  As in the JAX
package, no model calls ``decode_attention`` or ``ssd_scan``: decode goes
through ``attention.attend_decode_plus_new[_gqa]`` and the Mamba2 block
through ``mamba2.ssd_chunked``, the kernels' oracle consumers.
"""
from __future__ import annotations

import torch

from repro_torch import obs

from .decode_attention import decode_attention_bhsd
from .flash_attention import flash_attention_bhtd
from .ssd_scan import ssd_scan_bhtpn


def flash_attention(q, k, v, *, q_pos=None, k_pos=None, window=None, scale):
    """(B,H,T,hd) attention; positions must be contiguous from 0."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    with obs.span("kernels.flash_attention", bh=b * h, t=t, hd=hd, itemsize=q.element_size()):
        out = flash_attention_bhtd(
            q.reshape(b * h, t, hd),
            k.reshape(b * h, s, hd),
            v.reshape(b * h, s, hd),
            scale=scale,
            window=window,
        )
        return out.reshape(b, h, t, hd)


def decode_attention(q, k, v, valid, *, scale):
    """q (B,H,1,hd), k/v (B,H,S,hd), valid (S,) or (B,S)."""
    b, h, _, hd = q.shape
    s = k.shape[2]
    if valid.dim() == 1:
        valid = valid[None].expand(b, s)
    validbh = valid[:, None, :].expand(b, h, s).reshape(b * h, s)
    out = decode_attention_bhsd(
        q.reshape(b * h, 1, hd),
        k.reshape(b * h, s, hd),
        v.reshape(b * h, s, hd),
        validbh.to(torch.int32),
        scale=scale,
    )
    return out.reshape(b, h, 1, hd)


def ssd_scan(x, dt, a, b, c, *, chunk=128):
    """x (B,T,H,P), dt (B,T,H), a (H,), b/c (B,T,G,N) with G broadcast to H."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    bh = torch.repeat_interleave(b, rep, dim=2)
    ch = torch.repeat_interleave(c, rep, dim=2)
    out = ssd_scan_bhtpn(
        x.permute(0, 2, 1, 3).reshape(bsz * h, t, p),
        dt.permute(0, 2, 1).reshape(bsz * h, t, 1),
        a[None].expand(bsz, h).reshape(bsz * h, 1),
        bh.permute(0, 2, 1, 3).reshape(bsz * h, t, n),
        ch.permute(0, 2, 1, 3).reshape(bsz * h, t, n),
        q=chunk,
    )
    return out.reshape(bsz, h, t, p).permute(0, 2, 1, 3)
