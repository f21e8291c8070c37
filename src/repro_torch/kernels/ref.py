"""Plain PyTorch oracles for the port's model kernels (K3, K4, K5).

Each oracle is the mathematically direct formulation (full attention
matrices, the per-step SSM recurrence) with float32 accumulation, so the
tiled kernels are held against code that shares nothing with them.

``flash_attention_tiled_ref`` is the exception: it repeats the arithmetic
of K3's bf16 tensor-core instance (its tiles, its live-tile walk, its online
softmax and its bf16 hi + lo terms of P), so that the kernel can be held to
it far more tightly than to the oracle.  Only tests and ``chip_smoke.py`` call
it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38
LOG2E = math.log2(math.e)
FLASH_BQ = 64  # query rows of one K3 block


def flash_tile_plan(hd: int) -> tuple[int, int]:
    """(query rows, keys) of one tile of K3's bf16 instance at head dim ``hd``:
    64 keys up to hd 64, 32 above (registers: the accumulators of 16 x hd
    outputs a warp leave little room for a wider score tile)."""
    return FLASH_BQ, (64 if hd <= 64 else 32)


def flash_live_kv_tiles(q0: int, t: int, bq: int, bk: int, window: int | None) -> range:
    """The KV tiles of ``bk`` keys that query rows ``[q0, min(q0 + bq, t))``
    walk: up to the causal diagonal, and from the first tile whose last key
    is inside the first row's window.  Every tile in the range keeps a key
    for some row, and no tile outside it does."""
    hi = (min(q0 + bq, t) - 1) // bk
    if window is None:
        return range(0, hi + 1)
    first = q0 - window - bk + 2  # the lowest first key of a live tile
    return range(0 if first <= 0 else -(-first // bk), hi + 1)


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


def flash_attention_tiled_ref(
    q: torch.Tensor,  # (BH, T, hd)
    k: torch.Tensor,  # (BH, T, hd)
    v: torch.Tensor,
    *,
    scale: float,
    window: int | None = None,
) -> torch.Tensor:
    """K3's bf16 instance in plain PyTorch: for each 64-row query tile, the
    live KV tiles of :func:`flash_tile_plan` in ascending order; scores
    accumulated in float32 and taken in log2 units; an online softmax with
    float32 running max and sum; P as two terms in the input dtype (P
    rounded, and the rest rounded), each multiplied into V with float32
    accumulation; ``acc / max(l, 1e-30)`` rounded to the input dtype.  Keys
    past ``T`` are zeros, as the kernel loads them, and masked."""
    bh, t, hd = q.shape
    bq, bk = flash_tile_plan(hd)
    f32, dev = torch.float32, q.device
    pad = -t % bk
    kp_all = torch.nn.functional.pad(k.to(f32), (0, 0, 0, pad))
    vp_all = torch.nn.functional.pad(v.to(f32), (0, 0, 0, pad))
    neg = torch.full((), NEG_INF, dtype=f32, device=dev)
    out = torch.empty_like(q)
    for q0 in range(0, t, bq):
        rows = min(bq, t - q0)
        qt = q[:, q0:q0 + rows].to(f32)
        qp = torch.arange(q0, q0 + rows, device=dev)[:, None]
        m = torch.full((bh, rows), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((bh, rows), dtype=f32, device=dev)
        acc = torch.zeros((bh, rows, hd), dtype=f32, device=dev)
        for kt in flash_live_kv_tiles(q0, t, bq, bk, window):
            k0 = kt * bk
            kb, vb = kp_all[:, k0:k0 + bk], vp_all[:, k0:k0 + bk]
            kp = torch.arange(k0, k0 + bk, device=dev)[None, :]
            keep = qp >= kp
            if window is not None:
                keep &= (qp - kp) < window
            s = torch.where(keep[None], (qt @ kb.transpose(1, 2)) * (scale * LOG2E), neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            p_hi = p.to(q.dtype).to(f32)
            p_lo = (p - p_hi).to(q.dtype).to(f32)
            acc = acc * alpha[..., None] + p_hi @ vb + p_lo @ vb
            m = m_new
        out[:, q0:q0 + rows] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


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
