"""Shared NN building blocks (plain functions on tensors; params are dicts).

Conventions, as in the JAX package:

* Every ``init_*`` returns a dict of float32 "master" tensors, drawn from an
  explicit ``torch.Generator`` on that generator's device.
* Every apply-style function takes ``(params, x, ...)`` and computes in the
  dtype of ``x`` (bf16 by default), casting weights on the fly.
* Weight shapes keep the named structure of the reference: attention
  projections are (d_model, n_heads, head_dim), so checkpoints match leaf
  for leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

PyTree = Any
_F32 = torch.float32


def _normal(gen: torch.Generator, shape, scale) -> torch.Tensor:
    out = torch.randn(tuple(shape), generator=gen, dtype=_F32, device=gen.device)
    return out.mul_(scale)


def _zeros(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=_F32, device=gen.device)


def _ones(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=_F32, device=gen.device)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def init_norm(kind: str, dim: int, gen: torch.Generator, lead: tuple = ()) -> PyTree:
    p = {"scale": _ones(gen, (*lead, dim))}
    if kind == "layernorm":
        p["bias"] = _zeros(gen, (*lead, dim))
    return p


def apply_norm(kind: str, p: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(_F32)
    if kind == "rmsnorm":
        x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
        return (x32 * p["scale"]).to(dt)
    elif kind == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
        x32 = (x32 - mu) * torch.rsqrt(var + eps)
        return (x32 * p["scale"] + p["bias"]).to(dt)
    raise ValueError(kind)


# ----------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ----------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, *,
             bias: bool = False, lead: tuple = ()) -> PyTree:
    scale_in = d_model**-0.5
    scale_out = d_ff**-0.5
    p: PyTree = {"w_out": _normal(gen, (*lead, d_ff, d_model), scale_out)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (*lead, d_model, d_ff), scale_in)
    p["w_up"] = _normal(gen, (*lead, d_model, d_ff), scale_in)
    if bias:
        p["b_up"] = _zeros(gen, (*lead, d_ff))
        p["b_out"] = _zeros(gen, (*lead, d_model))
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: PyTree, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        h = (F.silu(g) if act == "swiglu" else _gelu(g)) * u
    else:
        h = x @ p["w_up"].to(dt)
        if "b_up" in p:
            h = h + p["b_up"].to(dt)
        h = _gelu(h)
    y = h @ p["w_out"].to(dt)
    if "b_out" in p:
        y = y + p["b_out"].to(dt)
    return y


# ----------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, rope_pct: float = 1.0) -> np.ndarray:
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    return inv.astype(np.float32)  # (rot_dim/2,)


def apply_rope(
    x: torch.Tensor,  # (..., T, head_dim)
    positions: torch.Tensor,  # (..., T) integer
    inv_freq: torch.Tensor,  # (rot/2,) float32
) -> torch.Tensor:
    rot = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., None].to(_F32) * inv_freq  # (..., T, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot < x.shape[-1] else y


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> PyTree:
    return {"table": _normal(gen, (vocab, d_model), 0.02)}


def embed(p: PyTree, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    return p["table"][tokens].to(dtype)


def unembed(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table."""
    return x @ p["table"].to(x.dtype).T


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False) -> PyTree:
    p = {"w": _normal(gen, (d_in, d_out), d_in**-0.5)}
    if bias:
        p["b"] = _zeros(gen, (d_out,))
    return p


def apply_linear(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ----------------------------------------------------------------------
# Cross-entropy
# ----------------------------------------------------------------------
def softmax_xent(
    logits: torch.Tensor,  # (..., V)
    labels: torch.Tensor,  # (...,) integer
    *,
    z_loss: float = 0.0,
) -> torch.Tensor:
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    return loss
