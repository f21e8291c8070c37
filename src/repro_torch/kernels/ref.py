"""Plain PyTorch oracles for the port's model kernels (K3, K4, K5).

Each oracle is the mathematically direct formulation (full attention
matrices, the per-step SSM recurrence) with float32 accumulation, so the
tiled kernels are held against code that shares nothing with them.

``flash_attention_tiled_ref``, ``decode_attention_tiled_ref`` and
``ssd_scan_tiled_ref`` are the exceptions: they repeat the arithmetic of
K3's bf16 tensor-core instance (its tiles, its live-tile walk, its online
softmax and its bf16 hi + lo terms of P), of K4's bf16 instance (its
64-key tiles, the skip of tiles with no valid key, its interleaved splits
and their merge in split order) and of K5's three passes (chunk states,
state passing, 64-row tiles of the chunk scan, bf16 hi + lo terms of every
float32 operand), so that the kernels can be held to them far more tightly
than to the oracles.  Only tests and ``chip_smoke.py`` call them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38
LOG2E = math.log2(math.e)
FLASH_BQ = 64  # query rows of one K3 block
SSD_TILE = 64  # rows of a query or key tile of K5's chunk scan
DECODE_TILE = 64  # keys of one tile of K4's bf16 instance
DECODE_BLOCKS = 132  # blocks a K4 launch aims at: one for each of an H100's 132 SMs
DECODE_MAX_SPLIT_TILES = 1024  # tiles one K4 block may own (a mask word each in shared memory)


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


def decode_split_plan(bh: int, s: int) -> tuple[int, int]:
    """(tiles, splits) of one row of K4's bf16 instance: ``S`` cut into
    tiles of ``DECODE_TILE`` keys (the last one ragged), and as many splits
    as fill ``DECODE_BLOCKS`` blocks over ``bh`` rows, at least one, at most
    one a tile, and enough that no split owns more than
    ``DECODE_MAX_SPLIT_TILES`` tiles.  Split ``sp`` owns tiles ``sp, sp +
    nsplit, ...``, so a valid run of any layout spreads over the splits."""
    ntiles = -(-s // DECODE_TILE)
    nsplit = max(1, DECODE_BLOCKS // max(bh, 1), -(-ntiles // DECODE_MAX_SPLIT_TILES))
    return ntiles, min(nsplit, ntiles)


def decode_attention_tiled_ref(
    q: torch.Tensor,  # (BH, 1, hd)
    k: torch.Tensor,  # (BH, S, hd)
    v: torch.Tensor,
    valid: torch.Tensor,  # (BH, S) int32
    *,
    scale: float,
    nsplit: int | None = None,
) -> torch.Tensor:
    """K4's bf16 instance in plain PyTorch, float32 throughout.

    Each split (``decode_split_plan``, or ``nsplit`` given) walks the tiles
    it owns in ascending order and skips, for each row, a tile with no valid
    key: its k and v enter nothing, so non-finite values there cannot reach
    the output.  In a tile it reads, a masked key is selected out of the
    scores, the weights and v (never multiplied by a zero weight).  The
    split keeps an online softmax (m, l, acc) from ``m = NEG_INF, l = 0``;
    a split that read nothing merges with weight ``exp(m - M) l = 0``.  The
    merge takes the splits in order: ``M = max m``, ``out = sum e^(m - M)
    acc / sum e^(m - M) l``.  A row with no valid key at all (every split
    empty) is the mean of v over all ``S`` slots, as the oracle's uniform
    softmax gives.  Output in q's dtype."""
    bh, s, hd = k.shape
    f32, dev = torch.float32, q.device
    ntiles, plan = decode_split_plan(bh, s)
    nsplit = plan if nsplit is None else nsplit
    if not 1 <= nsplit <= ntiles:
        raise ValueError(f"nsplit={nsplit} outside [1, {ntiles}]")
    qf = q[:, 0].to(f32)
    ok = valid > 0
    neg = torch.full((), NEG_INF, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    parts = []
    for sp in range(nsplit):
        m = torch.full((bh,), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros(bh, dtype=f32, device=dev)
        acc = torch.zeros((bh, hd), dtype=f32, device=dev)
        for t in range(sp, ntiles, nsplit):
            keys = slice(t * DECODE_TILE, min((t + 1) * DECODE_TILE, s))
            okt = ok[:, keys]
            read = okt.any(-1)
            sc = torch.where(okt, torch.einsum("bd,bnd->bn", qf, k[:, keys].to(f32)) * scale, neg)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(okt, torch.exp(sc - m_new[:, None]), zero)
            vt = torch.where(okt[..., None], v[:, keys].to(f32), zero)
            l = torch.where(read, l * alpha + p.sum(-1), l)
            acc = torch.where(read[:, None], acc * alpha[:, None] + torch.einsum("bn,bnd->bd", p, vt),
                              acc)
            m = torch.where(read, m_new, m)
        parts.append((m, l, acc))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros((bh, hd), dtype=f32, device=dev)
    den = torch.zeros(bh, dtype=f32, device=dev)
    for m, l, acc in parts:
        w = torch.exp(m - big)
        num = num + w[:, None] * acc
        den = den + w * l
    out = num / den.clamp_min(1e-30)[:, None]
    out = torch.where((den == 0)[:, None], v.to(f32).mean(1), out)
    return out[:, None].to(q.dtype)


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


def ssd_scan_tiled_ref(
    x: torch.Tensor,  # (BH, T, P)
    dt: torch.Tensor,  # (BH, T, 1)
    a: torch.Tensor,  # (BH, 1)
    b: torch.Tensor,  # (BH, T, N)
    c: torch.Tensor,  # (BH, T, N)
    *,
    q: int = 128,
) -> torch.Tensor:
    """K5's three passes in plain PyTorch, chunk ``min(q, T)``:

    1. per chunk, ``a_cum = cumsum(dt A)`` and the chunk state
       ``dS = (w x)^T B`` with ``w = dt exp(a_cum[-1] - a_cum)``;
    2. the state entering each chunk, ``S_0 = 0``,
       ``S_{c+1} = exp(a_cum_c[-1]) S_c + dS_c``;
    3. per 64-row tile i of a chunk, ``y_i = exp(a_cum_i) (C_i S_in^T)
       + sum_{j <= i} G_ij x_j`` with ``G_ij = (C_i B_j^T) o L_ij o dt_j``
       and ``L_ij = exp(a_cum_i - a_cum_j)`` on and below the diagonal.

    Every product takes x, B or C as given and a float32 operand (``w x``,
    ``S_in``, ``G``); for bf16 inputs that operand enters as two terms in
    the input dtype, ``hi`` rounded and ``lo`` the rest rounded, each
    multiplied with float32 accumulation, as the tensor-core instance does.
    float32 inputs take every operand unrounded.  y in x's dtype."""
    f32 = torch.float32
    bh, t, p = x.shape
    n = b.shape[2]
    q = min(q, t)
    nc = t // q
    split = x.dtype != f32

    def terms(v: torch.Tensor) -> tuple:
        if not split:
            return (v,)
        hi = v.to(x.dtype).to(f32)
        return hi, (v - hi).to(x.dtype).to(f32)

    xf = x.to(f32).reshape(bh, nc, q, p)
    bf = b.to(f32).reshape(bh, nc, q, n)
    cf = c.to(f32).reshape(bh, nc, q, n)
    dtf = dt.to(f32).reshape(bh, nc, q)
    acum = torch.cumsum(dtf * a.to(f32).reshape(bh, 1, 1), dim=-1)
    total = acum[..., -1]  # (BH, NC)

    # pass 1: chunk states
    wx = (dtf * torch.exp(total[..., None] - acum))[..., None] * xf
    ds = sum(v.transpose(-1, -2) @ bf for v in terms(wx))  # (BH, NC, P, N)
    # pass 2: the state entering each chunk
    s_in = torch.empty_like(ds)
    s = torch.zeros_like(ds[:, 0])
    for ci in range(nc):
        s_in[:, ci] = s
        s = torch.exp(total[:, ci])[:, None, None] * s + ds[:, ci]
    # pass 3: the chunk scan, 64-row tiles
    y = torch.empty((bh, nc, q, p), dtype=f32, device=x.device)
    zero = torch.zeros((), dtype=f32, device=x.device)
    s_terms = terms(s_in)
    for i0 in range(0, q, SSD_TILE):
        rows = slice(i0, min(i0 + SSD_TILE, q))
        ci_ = cf[:, :, rows]
        acc = sum(ci_ @ v.transpose(-1, -2) for v in s_terms) * torch.exp(acum[:, :, rows, None])
        ri = torch.arange(rows.start, rows.stop, device=x.device)[:, None]
        for j0 in range(0, i0 + 1, SSD_TILE):
            cols = slice(j0, min(j0 + SSD_TILE, q))
            cj = torch.arange(cols.start, cols.stop, device=x.device)[None, :]
            keep = cj <= ri
            decay = torch.exp(acum[:, :, rows, None] - acum[:, :, None, cols])
            g = torch.where(keep, (ci_ @ bf[:, :, cols].transpose(-1, -2)) * decay
                            * dtf[:, :, None, cols], zero)
            acc = acc + sum(v @ xf[:, :, cols] for v in terms(g))
        y[:, :, rows] = acc
    return y.reshape(bh, t, p).to(x.dtype)
