"""Mamba2 (SSD — state-space duality) block, in plain PyTorch.

Implements the chunked SSD algorithm (Dao & Gu, 2024) for train/prefill and
the O(1) recurrent step for decode, as the JAX package does: within-chunk
work is dense products, cross-chunk state passing a short loop over chunks.
This module is the oracle consumer of the port's SSD-scan kernel
(``repro_torch.kernels.ssd_scan``); as in the JAX package, the model itself
runs ``ssd_chunked``.

Shapes: x (B,T,H,P) heads×headdim, dt (B,T,H), A (H,) [negative],
B/C (B,T,G,N) with G groups broadcast over H heads, state (B,H,P,N).

With the tracer on (:mod:`repro_torch.obs`), each SSD call of a model
records a ``mamba.ssd`` span (:func:`ssd_span`), the building of a prompt's
decode cache a ``mamba.prefill_state`` span and one of the counters
``mamba.state_from_output`` / ``mamba.state_only_passes`` (which way its
state came), and each decode recurrence a ``mamba.step`` span.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs

from .layers import _normal, _ones, _zeros, apply_norm, init_norm

PyTree = Any
_F32 = torch.float32


def init_mamba(gen: torch.Generator, cfg, lead: tuple = ()) -> PyTree:
    """Float32 master params drawn from ``gen`` at the reference's scales."""
    s = cfg.ssm
    d = cfg.d_model
    h, p, g, n = s.n_heads, s.head_dim, s.n_groups, s.d_state
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=_F32, device=gen.device))
    params = {
        "w_x": _normal(gen, (*lead, d, h * p), d**-0.5),
        "w_z": _normal(gen, (*lead, d, h * p), d**-0.5),
        "w_B": _normal(gen, (*lead, d, g * n), d**-0.5),
        "w_C": _normal(gen, (*lead, d, g * n), d**-0.5),
        "w_dt": _normal(gen, (*lead, d, h), d**-0.5),
        "dt_bias": _zeros(gen, (*lead, h)),
        "A_log": a_log.expand(*lead, h).clone(),
        "D": _ones(gen, (*lead, h)),
        "conv_x": _normal(gen, (*lead, s.conv_width, h * p), 0.2),
        "conv_B": _normal(gen, (*lead, s.conv_width, g * n), 0.2),
        "conv_C": _normal(gen, (*lead, s.conv_width, g * n), 0.2),
        "out_norm": init_norm("rmsnorm", h * p, gen, lead),
        "w_out": _normal(gen, (*lead, h * p, d), (h * p) ** -0.5),
    }
    if s.conv_bias:
        for name, width in (("x", h * p), ("B", g * n), ("C", g * n)):
            params[f"conv_{name}_bias"] = _zeros(gen, (*lead, width))
    return params


def causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv: x (B,T,Ch), kernel (W,Ch), bias (Ch,) or None."""
    w = kernel.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):  # W is 4: the reference's unrolled taps, in its order
        out = out + pad[:, i : i + t, :] * kernel[i].to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)


def conv_step(x_new: torch.Tensor, conv_state: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None):
    """One decode step. x_new (B,Ch); conv_state (B,W-1,Ch) holds history
    (the raw inputs, never the biased outputs)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B,W,Ch), promoted
    y = torch.einsum("bwc,wc->bc", window.to(x_new.dtype), kernel.to(x_new.dtype))
    if bias is not None:
        y = y + bias.to(x_new.dtype)
    return y, window[:, 1:, :]


def ssd_span(rows: int, t: int, s, chunk: int, *, keeps: str):
    """The ``mamba.ssd`` span of one SSD call over ``rows`` x ``t`` steps of
    SSM config ``s`` at ``chunk``; ``keeps`` is ``output``, ``state`` or
    ``both``, the part of the result the caller uses."""
    return obs.span("mamba.ssd", rows=rows, t=t, heads=s.n_heads, head_dim=s.head_dim,
                    d_state=s.d_state, chunk=chunk, keeps=keeps)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-triangular pairwise sums s[i,j]=sum(a[j+1..i])."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), -torch.inf, dtype=diff.dtype, device=a.device))


def _chunks(v: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B,T,...) -> (B,nc,Q,...), T padded with zeros to whole chunks (padded
    steps have dt = 0: no decay, no input)."""
    b, t = v.shape[:2]
    nc = -(-t // chunk)
    if nc * chunk != t:
        v = F.pad(v, (0, 0) * (v.dim() - 2) + (0, nc * chunk - t))
    return v.reshape(b, nc, chunk, *v.shape[2:])


def _ssd_prepare(x, dt, A, Bm, *, chunk: int, cdt, init_state):
    """What the output and the final state of the chunked SSD share: B
    repeated over heads (B,nc,Q,H,N), the per-step log-decays ``a`` and their
    within-chunk cumsum (B,nc,Q,H), dt·x (B,nc,Q,H,P) and the decays to each
    chunk's end (B,nc,Q,H) in ``cdt``, each chunk's whole decay (B,nc,H) and
    the initial state (B,H,P,N) in float32."""
    b, _, h, p = x.shape
    dtc = _chunks(dt, chunk).to(_F32)
    Bh = torch.repeat_interleave(_chunks(Bm, chunk), h // Bm.shape[2], dim=3)
    a = dtc * A  # log-decay per step
    a_cum = torch.cumsum(a, dim=2)  # within-chunk cumulative
    dtx = (_chunks(x, chunk).to(_F32) * dtc[..., None]).to(cdt)
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum).to(cdt)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])
    s = (init_state.to(_F32) if init_state is not None
         else torch.zeros((b, h, p, Bm.shape[3]), dtype=_F32, device=x.device))
    return Bh, a, a_cum, dtx, decay_to_end, chunk_decay, s


def _next_state(s, Bh_c, decay_to_end_c, dtx_c, chunk_decay_c):
    """One chunk of the inter-chunk pass: S_out = S_c + exp(Σa) · S_in."""
    s_c = torch.einsum("bqhn,bqh,bqhp->bhpn", Bh_c, decay_to_end_c, dtx_c).to(_F32)
    return s_c + chunk_decay_c[..., None, None] * s


def ssd_chunked(
    x: torch.Tensor,  # (B,T,H,P)
    dt: torch.Tensor,  # (B,T,H) — post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B,T,G,N)
    Cm: torch.Tensor,  # (B,T,G,N)
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
    intra_dtype: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,T,H,P), final_state (B,H,P,N)).

    ``intra_dtype="bf16"`` keeps the O(T·Q) decay matrices and partial
    products in bf16; cumulative log-decays and the inter-chunk state stay
    float32.
    """
    b, t, h, p = x.shape
    cdt = torch.bfloat16 if intra_dtype == "bf16" else _F32
    Bh, a, a_cum, dtx, decay_to_end, chunk_decay, s = _ssd_prepare(
        x, dt, A, Bm, chunk=chunk, cdt=cdt, init_state=init_state)
    Ch = torch.repeat_interleave(_chunks(Cm, chunk), h // Cm.shape[2], dim=3)
    nc = dtx.shape[1]

    # 1) intra-chunk (diagonal blocks): Y = (L ∘ (C Bᵀ)) (dt·x)
    L = torch.exp(_segsum(a.permute(0, 1, 3, 2))).to(cdt)  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh).to(cdt)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * L, dtx).to(_F32)

    # 2-4) inter-chunk pass: per chunk, y_off = C · exp(a_cum) · S_in and
    # S_out = S_c + exp(Σa) · S_in, with S_c built inside the loop
    decay_from_start = torch.exp(a_cum).to(cdt)  # (B,nc,Q,H)
    Bhc = Bh.to(cdt)
    Chc = Ch.to(cdt)
    y_off = []
    for ci in range(nc):
        y_off.append(torch.einsum("bqhn,bqh,bhpn->bqhp", Chc[:, ci],
                                  decay_from_start[:, ci], s.to(cdt)))
        s = _next_state(s, Bhc[:, ci], decay_to_end[:, ci], dtx[:, ci], chunk_decay[:, ci])
    y_off = torch.stack(y_off, dim=1)  # (B,nc,Q,H,P) in cdt

    y = (y_diag + y_off.to(_F32)).reshape(b, nc * chunk, h, p)[:, :t]
    return y.to(x.dtype), s


def ssd_final_state(
    x: torch.Tensor,  # (B,T,H,P)
    dt: torch.Tensor,  # (B,T,H) — post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B,T,G,N)
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
) -> torch.Tensor:
    """``ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)[1]``
    bit for bit: the same float32 preparation and inter-chunk state pass,
    without C and the decay matrices, scores and products that only the
    output reads."""
    Bh, _, _, dtx, decay_to_end, chunk_decay, s = _ssd_prepare(
        x, dt, A, Bm, chunk=chunk, cdt=_F32, init_state=init_state)
    Bhc = Bh.to(_F32)
    for ci in range(dtx.shape[1]):
        s = _next_state(s, Bhc[:, ci], decay_to_end[:, ci], dtx[:, ci], chunk_decay[:, ci])
    return s


def ssd_step(
    x: torch.Tensor,  # (B,H,P)
    dt: torch.Tensor,  # (B,H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B,G,N)
    Cm: torch.Tensor,  # (B,G,N)
    state: torch.Tensor,  # (B,H,P,N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. Returns (y (B,H,P), new_state)."""
    h = x.shape[1]
    g = Bm.shape[1]
    rep = h // g
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(_F32)  # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(_F32)
    dt32 = dt.to(_F32)
    decay = torch.exp(dt32 * A)  # (B,H)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt32, Bh, x.to(_F32))
    new_state = decay[..., None, None] * state + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# ----------------------------------------------------------------------
# Full block (in_proj → conv → SSD → gate → out_proj)
# ----------------------------------------------------------------------
def apply_mamba(
    p: PyTree,
    x: torch.Tensor,  # (B,T,d)
    cfg,
    *,
    cache: Optional[PyTree] = None,  # decode: conv+ssm state
    chunk: int = 256,
    prefill_cache: bool = False,
) -> tuple[torch.Tensor, Optional[PyTree]]:
    """Returns (y (B,T,d), decode cache or None).  In decode (``cache``
    given) the cache is the new conv + ssm state, a new dict the caller
    writes into its buffers.  Over a prompt (no ``cache``) it is the prompt's
    decode cache when ``prefill_cache`` asks for one: the raw projections'
    last w − 1 steps and the SSD's float32 final state.  With float32
    intra-chunk tensors that state is the output's own SSD's; with bf16 ones
    a float32 state-only pass (:func:`ssd_final_state`) computes it."""
    s = cfg.ssm
    h, pd, g, n = s.n_heads, s.head_dim, s.n_groups, s.d_state
    dt_ = x.dtype
    b, t, _ = x.shape
    xs = x @ p["w_x"].to(dt_)  # (B,T,H*P)
    z = x @ p["w_z"].to(dt_)
    Bp = x @ p["w_B"].to(dt_)  # (B,T,G*N)
    Cp = x @ p["w_C"].to(dt_)
    dt_raw = x @ p["w_dt"].to(dt_)  # (B,T,H)
    A = -torch.exp(p["A_log"])  # (H,)

    if cache is None:
        # the decode conv state's history: the raw projections
        raw = {"conv_x": xs, "conv_B": Bp, "conv_C": Cp} if prefill_cache else None
        xs = F.silu(causal_conv(xs, p["conv_x"], p.get("conv_x_bias")))
        Bp = F.silu(causal_conv(Bp, p["conv_B"], p.get("conv_B_bias")))
        Cp = F.silu(causal_conv(Cp, p["conv_C"], p.get("conv_C_bias")))
        dt_v = F.softplus(dt_raw.to(_F32) + p["dt_bias"])
        state_from_output = prefill_cache and s.intra_dtype == "f32"
        with ssd_span(b, t, s, chunk, keeps="both" if state_from_output else "output"):
            y, final = ssd_chunked(
                xs.reshape(b, t, h, pd),
                dt_v,
                A,
                Bp.reshape(b, t, g, n),
                Cp.reshape(b, t, g, n),
                chunk=chunk,
                intra_dtype=s.intra_dtype,
            )
        new_cache = None
        if prefill_cache:
            with obs.span("mamba.prefill_state"):
                w = s.conv_width
                new_cache = {k: v[:, -(w - 1):, :].contiguous() for k, v in raw.items()}
                if state_from_output:
                    obs.count("mamba.state_from_output", 1)
                else:
                    obs.count("mamba.state_only_passes", 1)
                    with ssd_span(b, t, s, chunk, keeps="state"):
                        final = ssd_final_state(xs.reshape(b, t, h, pd), dt_v, A,
                                                Bp.reshape(b, t, g, n), chunk=chunk)
                new_cache["ssm"] = final
    else:
        if t != 1:
            raise ValueError(f"decode path expects a single new token, got T={t}")
        with obs.span("mamba.step"):
            xs1, conv_x = conv_step(xs[:, 0], cache["conv_x"], p["conv_x"], p.get("conv_x_bias"))
            Bp1, conv_B = conv_step(Bp[:, 0], cache["conv_B"], p["conv_B"], p.get("conv_B_bias"))
            Cp1, conv_C = conv_step(Cp[:, 0], cache["conv_C"], p["conv_C"], p.get("conv_C_bias"))
            xs1, Bp1, Cp1 = F.silu(xs1), F.silu(Bp1), F.silu(Cp1)
            dt_v = F.softplus(dt_raw[:, 0].to(_F32) + p["dt_bias"])
            y1, ssm = ssd_step(
                xs1.reshape(b, h, pd),
                dt_v,
                A,
                Bp1.reshape(b, g, n),
                Cp1.reshape(b, g, n),
                cache["ssm"],
            )
        y = y1[:, None]  # (B,1,H,P)
        xs = xs1[:, None]
        new_cache = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C, "ssm": ssm}

    # D repeated per head dim: jnp's axis-less repeat is repeat_interleave
    yd = y.reshape(b, t, h * pd) + xs.reshape(b, t, h * pd) * torch.repeat_interleave(
        p["D"].to(dt_), pd
    )
    yd = yd * F.silu(z)
    yd = apply_norm("rmsnorm", p["out_norm"], yd)
    return yd @ p["w_out"].to(dt_), new_cache


def init_mamba_cache(cfg, batch: int, dtype, device="cuda", lead: tuple = ()) -> PyTree:
    """Zeroed decode cache: conv histories in ``dtype``, the SSM state in float32."""
    s = cfg.ssm
    h, pd, g, n = s.n_heads, s.head_dim, s.n_groups, s.d_state
    w = s.conv_width
    return {
        "conv_x": torch.zeros((*lead, batch, w - 1, h * pd), dtype=dtype, device=device),
        "conv_B": torch.zeros((*lead, batch, w - 1, g * n), dtype=dtype, device=device),
        "conv_C": torch.zeros((*lead, batch, w - 1, g * n), dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, h, pd, n), dtype=_F32, device=device),
    }
