"""Plain PyTorch oracles for the port's attention kernel.

Each oracle is the mathematically direct formulation (the full attention
matrix) with float32 accumulation, so the tiled kernel is held against code
that shares nothing with it.  The decode and SSD oracles come with their
kernels (ROADMAP Queue 2).
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,  # (BH, T, hd)
    k: torch.Tensor,  # (BH, S, hd)
    v: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    t, s = q.shape[1], k.shape[1]
    f32 = torch.float32
    logits = torch.einsum("btd,bsd->bts", q.to(f32), k.to(f32)) * scale
    qp = torch.arange(t, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    logits = torch.where(mask[None], logits, torch.full((), NEG_INF, dtype=f32, device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w, v.to(f32)).to(q.dtype)
