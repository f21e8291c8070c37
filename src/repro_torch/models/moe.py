"""Mixture-of-Experts with capacity-based top-k routing (+ shared experts).

As in the JAX package, dispatch and combine are index scatter/gather (not a
one-hot einsum, whose (T, E, C) tensor is O(T²·k)):

  * top-k routing picks (expert, gate) per token-choice;
  * position-within-expert comes from a cumsum over the flattened choice
    list in token-major order; choices past the expert capacity map to the
    out-of-range row E·C and are dropped (their residual path passes
    through);
  * tokens are scatter-added into an (E·C, d) expert buffer;
  * the expert FFN is a batched einsum over (E, C, d);
  * combine gathers each choice's output row and weights it by the gate.

DeepSeek-MoE's *shared experts* (always-on) run densely alongside.  The
router adds the Switch-style load-balancing auxiliary loss.  The port has
no device mesh yet, so this is the JAX package's single-device branch.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .layers import _gelu, _normal, apply_mlp, init_mlp

PyTree = Any
_F32 = torch.float32


def init_moe(gen: torch.Generator, cfg, lead: tuple = ()) -> PyTree:
    """Float32 master params: the router and the stacked (E, d, f) experts."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    p: PyTree = {
        "router": _normal(gen, (*lead, d, e), d**-0.5),
        "w_gate": _normal(gen, (*lead, e, d, f), d**-0.5),
        "w_up": _normal(gen, (*lead, e, d, f), d**-0.5),
        "w_down": _normal(gen, (*lead, e, f, d), f**-0.5),
    }
    if m.n_shared > 0:
        p["shared"] = init_mlp(gen, d, m.d_expert * m.n_shared, cfg.act, lead=lead)
    return p


def route_topk(
    logits: torch.Tensor,  # (T, E) f32
    k: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (slot (T,k) int32 into E*C [E*C = dropped], gate (T,k) f32,
    eids (T,k) int32, aux_loss scalar)."""
    t, e = logits.shape
    probs = torch.softmax(logits.to(_F32), dim=-1)
    # sorted, as lax.top_k returns them: the choice order decides the drops
    gate_vals, eids = torch.topk(probs, k, dim=-1, largest=True, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert, in token order
    onehot = F.one_hot(eids, e)  # (T,k,E) int64
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos = (pos_in_expert * onehot).sum(-1)  # (T,k)
    keep = pos < capacity
    slot = torch.where(keep, eids * capacity + pos, torch.full_like(pos, e * capacity))

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(eids[:, 0], e).to(_F32).mean(dim=0)
    aux = e * torch.sum(me * ce)
    return slot.to(torch.int32), gate_vals, eids.to(torch.int32), aux


def _dispatch_combine_plan(xf, router, m, t):
    """Routing + scatter for the tokens in ``xf``."""
    n_tok, d = xf.shape
    logits = xf.to(_F32) @ router.to(_F32)
    if t == 1:  # decode: capacity covers every token — no drops at inference
        capacity = n_tok
    else:
        capacity = int(n_tok * m.top_k / m.n_experts * m.capacity_factor)
        capacity = max(capacity, m.top_k)
    slot, gate, _, aux = route_topk(logits, m.top_k, capacity)
    e = m.n_experts
    upd = xf[:, None, :].expand(n_tok, m.top_k, d).reshape(-1, d)
    # one spare row takes every dropped choice and is cut off: the
    # reference's scatter with mode="drop"
    buf = torch.zeros((e * capacity + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot.reshape(-1).long(), upd)
    return buf[:-1].reshape(e, capacity, d), slot, gate, aux, capacity


def apply_moe(p: PyTree, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,d) -> (y (B,T,d), aux_loss scalar)."""
    m = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    xf = x.reshape(n_tok, d)
    dt = x.dtype
    xe, slot, gate, aux, _ = _dispatch_combine_plan(xf, p["router"], m, t)

    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(dt))
    h = (F.silu(g) if cfg.act == "swiglu" else _gelu(g)) * u
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))  # (E,C,d)

    e_, cap, d_ = ye.shape
    yef = ye.reshape(-1, d_)
    got = yef[torch.clamp(slot, max=e_ * cap - 1).long()]  # (T,k,d)
    keep = (slot < e_ * cap).to(_F32)
    w = (gate * keep).to(got.dtype)
    y = torch.einsum("tkd,tk->td", got, w).to(dt)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, cfg.act)
    return y.reshape(b, t, d), aux
