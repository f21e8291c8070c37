"""Attention: GQA projections, causal/sliding-window masks, three impls.

Implementations (selected by ``config.attn_impl``), as in the JAX package:
  * ``full``    — materializes (T, S) scores; for smoke tests / short seqs.
  * ``chunked`` — a loop over KV chunks with an online softmax (flash-style
                  in plain PyTorch); memory O(T · chunk).
  * ``pallas``  — the port's hand-written flash-attention kernel
                  (``repro_torch.kernels.ops.flash_attention``): CUDA on a
                  CUDA tensor, its plain version on a CPU tensor.  The name
                  is the reference's, so configs carry over unchanged.

Decode (q_len == 1 against a long cache) uses a dedicated path that never
materializes more than (B, H, S) scores.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .layers import _normal, _ones, _zeros, apply_rope

PyTree = Any
NEG_INF = -2.0e38
_F32 = torch.float32


def init_attention(gen: torch.Generator, cfg, lead: tuple = ()) -> PyTree:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _normal(gen, (*lead, d, h, hd), d**-0.5),
        "wk": _normal(gen, (*lead, d, hk, hd), d**-0.5),
        "wv": _normal(gen, (*lead, d, hk, hd), d**-0.5),
        "wo": _normal(gen, (*lead, h, hd, d), (h * hd) ** -0.5),
    }
    if cfg.attn_bias:
        p["bq"] = _zeros(gen, (*lead, h, hd))
        p["bk"] = _zeros(gen, (*lead, hk, hd))
        p["bv"] = _zeros(gen, (*lead, hk, hd))
        p["bo"] = _zeros(gen, (*lead, d))
    if cfg.qk_norm:
        p["q_norm"] = {"scale": _ones(gen, (*lead, hd))}
        p["k_norm"] = {"scale": _ones(gen, (*lead, hd))}
    return p


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=_F32, device=like.device)


def _rms(x, scale, eps=1e-6):
    x32 = x.to(_F32)
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def qkv_proj(p: PyTree, x: torch.Tensor, cfg, positions: torch.Tensor, inv_freq):
    """x (B,T,d) -> q (B,H,T,hd), k/v (B,Hkv,T,hd), RoPE applied."""
    dt = x.dtype
    q = torch.einsum("btd,dhk->bhtk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bhtk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bhtk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)[None, :, None, :]
        k = k + p["bk"].to(dt)[None, :, None, :]
        v = v + p["bv"].to(dt)[None, :, None, :]
    if "q_norm" in p:
        q = _rms(q, p["q_norm"]["scale"])
        k = _rms(k, p["k_norm"]["scale"])
    if inv_freq is not None:
        pos = positions[:, None, :]  # (B,1,T) broadcasting over heads
        q = apply_rope(q, pos, inv_freq)
        k = apply_rope(k, pos, inv_freq)
    return q, k, v


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,Hkv,S,hd) -> (B,Hkv*n_rep,S,hd)."""
    if n_rep == 1:
        return k
    b, hk, s, hd = k.shape
    return k[:, :, None].expand(b, hk, n_rep, s, hd).reshape(b, hk * n_rep, s, hd)


def out_proj(p: PyTree, o: torch.Tensor) -> torch.Tensor:
    y = torch.einsum("bhtk,hkd->btd", o, p["wo"].to(o.dtype))
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


# ----------------------------------------------------------------------
# Masks
# ----------------------------------------------------------------------
def causal_window_mask(
    q_pos: torch.Tensor,  # (T,) query positions
    k_pos: torch.Tensor,  # (S,) key positions
    window: Optional[int],  # None => full causal
) -> torch.Tensor:
    """(T, S) bool; True = attend."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m = m & (q_pos[:, None] - k_pos[None, :] < window)
    return m


# ----------------------------------------------------------------------
# full
# ----------------------------------------------------------------------
def attend_full(
    q: torch.Tensor,  # (B,H,T,hd)
    k: torch.Tensor,  # (B,H,S,hd)
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # (T,S) or (B,1,T,S) bool
    scale: float,
) -> torch.Tensor:
    logits = torch.einsum("bhtk,bhsk->bhts", q, k).to(_F32) * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        logits = torch.where(mask, logits, _neg_inf(logits))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsk->bhtk", w, v)


# ----------------------------------------------------------------------
# chunked (flash-style: Q tiles outer, KV tiles inner, plain PyTorch)
# ----------------------------------------------------------------------
def attend_chunked(
    q: torch.Tensor,  # (B,H,T,hd)
    k: torch.Tensor,  # (B,H,S,hd)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (T,)
    k_pos: torch.Tensor,  # (S,)
    window: Optional[int],
    scale: float,
    chunk: int = 1024,
) -> torch.Tensor:
    """Double-tiled online softmax: the accumulator carried through the KV
    loop is one Q tile (B,H,bq,hd), not the full sequence."""
    b, h, t, hd = q.shape
    s = k.shape[2]
    bq = min(chunk, t)
    bk = min(chunk, s)
    nq, nk = -(-t // bq), -(-s // bk)
    pad_q, pad_k = nq * bq - t, nk * bk - s
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=2**30 - 1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k), value=2**30)  # never attended

    # Sliding-window tile skipping: a query tile at index i only sees KV
    # tiles [i - ceil(window/bk), i] (positions are contiguous).
    w_tiles = None
    if window is not None and t == s and nk > 1:
        w_tiles = min(-(-window // bk) + 1, nk)  # window span + diagonal

    outs = []
    for qi in range(nq):
        qt = q[:, :, qi * bq:(qi + 1) * bq]
        qp = q_pos[qi * bq:(qi + 1) * bq]
        acc = torch.zeros((b, h, bq, hd), dtype=_F32, device=q.device)
        m = torch.full((b, h, bq), NEG_INF, dtype=_F32, device=q.device)
        l = torch.zeros((b, h, bq), dtype=_F32, device=q.device)
        kv_tiles = range(nk)
        if w_tiles is not None:
            start = min(max(qi - (w_tiles - 1), 0), nk - w_tiles)
            kv_tiles = range(start, start + w_tiles)
        for ki in kv_tiles:
            kt = k[:, :, ki * bk:(ki + 1) * bk]
            vt = v[:, :, ki * bk:(ki + 1) * bk]
            kp = k_pos[ki * bk:(ki + 1) * bk]
            logits = torch.einsum("bhtk,bhsk->bhts", qt, kt).to(_F32) * scale
            msk = causal_window_mask(qp, kp, window)
            logits = torch.where(msk[None, None], logits, _neg_inf(logits))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhts,bhsk->bhtk", p.to(qt.dtype), vt
            ).to(_F32)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(qt.dtype))
    return torch.cat(outs, dim=2)[:, :, :t]


# ----------------------------------------------------------------------
# decode: q_len == 1 against a cache
# ----------------------------------------------------------------------
def attend_decode(
    q: torch.Tensor,  # (B,H,1,hd)
    k: torch.Tensor,  # (B,H,S,hd)
    v: torch.Tensor,
    k_valid: torch.Tensor,  # (S,) bool — True where cache slot holds a real key
    scale: float,
) -> torch.Tensor:
    logits = torch.einsum("bhtk,bhsk->bhts", q, k).to(_F32) * scale
    logits = torch.where(k_valid[None, None, None, :], logits, _neg_inf(logits))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsk->bhtk", w, v)


def attend_decode_plus_new(
    q: torch.Tensor,  # (B,H,1,hd)
    k_cache: torch.Tensor,  # (B,H,S,hd) — the OLD cache, before this step's write
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B,H,1,hd) — this step's key/value
    v_new: torch.Tensor,
    k_valid: torch.Tensor,  # (S,) bool — valid OLD slots (excludes current pos)
    scale: float,
) -> torch.Tensor:
    l_old = torch.einsum("bhtk,bhsk->bhts", q, k_cache).to(_F32) * scale
    l_old = torch.where(k_valid[None, None, None, :], l_old, _neg_inf(l_old))
    l_new = torch.einsum("bhtk,bhsk->bhts", q, k_new).to(_F32) * scale
    m = torch.maximum(l_old.amax(dim=-1, keepdim=True), l_new)
    p_old = torch.exp(l_old - m)
    p_new = torch.exp(l_new - m)
    denom = p_old.sum(dim=-1, keepdim=True) + p_new
    o = torch.einsum("bhts,bhsk->bhtk", p_old.to(q.dtype), v_cache)
    o = o + p_new.to(q.dtype) * v_new
    return o / denom.to(q.dtype)


def attend_decode_plus_new_gqa(
    q: torch.Tensor,  # (B,H,1,hd) with H = Hkv * G
    k_cache: torch.Tensor,  # (B,Hkv,S,hd) — not repeated to H heads
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B,Hkv,1,hd)
    v_new: torch.Tensor,
    k_valid: torch.Tensor,  # (S,) bool
    scale: float,
) -> torch.Tensor:
    """GQA decode keeping the Hkv axis: the group dim lives on Q only."""
    b, h, _, hd = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd)
    l_old = torch.einsum("bkgd,bksd->bkgs", qg, k_cache).to(_F32) * scale
    l_old = torch.where(k_valid[None, None, None, :], l_old, _neg_inf(l_old))
    l_new = torch.einsum("bkgd,bksd->bkgs", qg, k_new).to(_F32) * scale
    m = torch.maximum(l_old.amax(dim=-1, keepdim=True), l_new)
    p_old = torch.exp(l_old - m)
    p_new = torch.exp(l_new - m)
    denom = p_old.sum(dim=-1, keepdim=True) + p_new
    o = torch.einsum("bkgs,bksd->bkgd", p_old.to(q.dtype), v_cache)
    o = o + p_new.to(q.dtype) * v_new[:, :, None, 0, :]
    o = o / denom.to(q.dtype)
    return o.reshape(b, h, 1, hd)


def attention(
    q, k, v, *, impl: str, q_pos, k_pos, window, scale, chunk: int = 1024
):
    """Dispatch on implementation for prefill/train (q_len == kv_len)."""
    if impl == "chunked":
        return attend_chunked(q, k, v, q_pos, k_pos, window, scale, chunk=chunk)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                    window=window, scale=scale)
    mask = causal_window_mask(q_pos, k_pos, window)
    return attend_full(q, k, v, mask, scale)
