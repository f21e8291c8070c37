"""Plain PyTorch oracles for the port's model kernels (K3, K4, K5).

Each oracle is the mathematically direct formulation (full attention
matrices, the per-step SSM recurrence) with float32 accumulation, so the
tiled kernels are held against code that shares nothing with them.
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


def decode_attention_ref(
    q: torch.Tensor,  # (BH, 1, hd)
    k: torch.Tensor,  # (BH, S, hd)
    v: torch.Tensor,
    valid: torch.Tensor,  # (BH, S) int32
    *,
    scale: float,
) -> torch.Tensor:
    f32 = torch.float32
    logits = torch.einsum("btd,bsd->bts", q.to(f32), k.to(f32)) * scale
    logits = torch.where(valid[:, None, :] > 0, logits,
                         torch.full((), NEG_INF, dtype=f32, device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w, v.to(f32)).to(q.dtype)


def ssd_scan_ref(
    x: torch.Tensor,  # (BH, T, P)
    dt: torch.Tensor,  # (BH, T, 1)
    a: torch.Tensor,  # (BH, 1)
    b: torch.Tensor,  # (BH, T, N)
    c: torch.Tensor,  # (BH, T, N)
) -> torch.Tensor:
    """Direct per-step recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t."""
    f32 = torch.float32
    bh, t, p = x.shape
    n = b.shape[2]
    h = torch.zeros((bh, p, n), dtype=f32, device=x.device)
    ys = []
    for i in range(t):
        xt, dtt = x[:, i].to(f32), dt[:, i].to(f32)  # (BH,P), (BH,1)
        decay = torch.exp(dtt * a)  # (BH,1)
        h = decay[..., None] * h + torch.einsum("bp,bn->bpn", xt * dtt, b[:, i].to(f32))
        ys.append(torch.einsum("bpn,bn->bp", h, c[:, i].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype)
