"""Mixture-of-Experts with capacity-based top-k routing (+ shared experts).

As in the JAX package, dispatch and combine are index scatter/gather (not a
one-hot einsum, whose (T, E, C) tensor is O(T²·k)):

  * top-k routing picks (expert, gate) per token-choice;
  * position-within-expert is the count of earlier choices of the same
    expert in the flattened token-major choice list (``kernels/moe_route.py``:
    a counting-scan kernel on the card, the one-hot cumsum on the CPU);
    choices past the expert capacity map to the out-of-range row E·C and are
    dropped (their residual path passes through);
  * tokens are scatter-added into an (E·C, d) expert buffer;
  * the expert FFN is a batched einsum over (E, C, d);
  * combine gathers each choice's output row and weights it by the gate.

Under a mesh (a ``sharding_context`` whose data axes hold dp > 1
positions, and a token count dp divides), routing and scatter run PER DATA
SHARD, as the reference's ``shard_map`` runs them: shard p owns the p-th
run of n/dp consecutive tokens (pod-major over ("pod", "data")), routes
them at its own capacity C, and fills capacity columns [p·C, (p+1)·C) of
an (E, dp·C, d) buffer; its combine reads back from those columns, and the
aux loss is the mean of the shards' own.  The shards are a leading dim of
one batched computation, not a loop.  The inputs and outputs of the two
are constrained to the layouts of the reference's shard_maps (split over
data alone; ``site="shard_map"`` for the inputs, whose cotangents the
reference sums over the model axis), which is where its expert-parallel
all-gathers and all-reduces come from.  Outside a mesh, the one-device
branch routes all tokens at one capacity.

DeepSeek-MoE's *shared experts* (always-on) run densely alongside.  The
router adds the Switch-style load-balancing auxiliary loss.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed.api import active_mesh, constrain
from repro_torch.kernels.moe_route import expert_slots

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
    logits: torch.Tensor,  # (..., T, E) f32
    k: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (slot (...,T,k) int32 into E*C [E*C = dropped], gate (...,T,k)
    f32, eids (...,T,k) int32, aux_loss (...)).  Leading dims are independent
    routings (one per data shard), each over its own T tokens."""
    t, e = logits.shape[-2:]
    probs = torch.softmax(logits.to(_F32), dim=-1)
    # sorted, as lax.top_k returns them: the choice order decides the drops
    gate_vals, top = torch.topk(probs, k, dim=-1, largest=True, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    eids = top.to(torch.int32)
    # position of each (token, choice) within its expert, in token order
    slot = expert_slots(eids.reshape(-1, t, k), e, capacity).reshape(eids.shape)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=-2)
    ce = F.one_hot(top[..., 0], e).to(_F32).mean(dim=-2)
    aux = e * torch.sum(me * ce, dim=-1)
    return slot, gate_vals, eids, aux


def _capacity(n_tok: int, m, t: int) -> int:
    if t == 1:  # decode: capacity covers every token — no drops at inference
        return n_tok
    return max(int(n_tok * m.top_k / m.n_experts * m.capacity_factor), m.top_k)


def _dispatch_combine_plan(xf, router, m, t):
    """Routing + scatter for the tokens in ``xf`` (the one-device branch)."""
    n_tok, d = xf.shape
    capacity = _capacity(n_tok, m, t)
    with obs.span("moe.route", tokens=n_tok, capacity=capacity):
        logits = xf.to(_F32) @ router.to(_F32)
        slot, gate, _, aux = route_topk(logits, m.top_k, capacity)
        e = m.n_experts
        upd = xf[:, None, :].expand(n_tok, m.top_k, d).reshape(-1, d)
        # one spare row takes every dropped choice and is cut off: the
        # reference's scatter with mode="drop"
        buf = torch.zeros((e * capacity + 1, d), dtype=xf.dtype, device=xf.device)
        buf.index_add_(0, slot.reshape(-1).long(), upd)
    return buf[:-1].reshape(e, capacity, d), slot, gate, aux, capacity


def _shard_dispatch_plan(xf, router, m, t, dp: int):
    """Routing + scatter with ``xf``'s tokens split into ``dp`` shards of
    consecutive tokens, each routed at its own capacity C.

    Returns the (E, dp·C, d) buffer, whose columns [p·C, (p+1)·C) are shard
    p's capacity slice; each (token, choice)'s row in the buffer flattened
    to (E·dp·C, d), where its combine reads (a dropped choice reads its
    shard's last row of the last expert, as the reference's clamped gather
    does, and is weighted 0); the keep mask; the gates; the shards' own
    slots (dp, n/dp, k) into E·C; the mean aux loss; and C."""
    n_tok, d = xf.shape
    n, e, k = n_tok // dp, m.n_experts, m.top_k
    capacity = _capacity(n, m, t)
    with obs.span("moe.route", tokens=n_tok, capacity=capacity, shards=dp):
        logits = (xf.to(_F32) @ router.to(_F32)).reshape(dp, n, e)
        slot, gate, _, aux = route_topk(logits, k, capacity)
        keep = slot < e * capacity
        # shard p's slot e·C + c is column p·C + c of expert e: row
        # e·dp·C + p·C + c of the flattened buffer
        shard = torch.arange(dp, device=xf.device).view(dp, 1, 1) * capacity
        slot = slot.long()
        eid, col = slot // capacity, shard + slot % capacity
        row = torch.where(keep, eid * (dp * capacity) + col, e * dp * capacity)
        upd = xf[:, None, :].expand(n_tok, k, d).reshape(-1, d)
        buf = torch.zeros((e * dp * capacity + 1, d), dtype=xf.dtype, device=xf.device)
        buf.index_add_(0, row.reshape(-1), upd)
        read = torch.where(keep, row, (e - 1) * dp * capacity + shard + capacity - 1)
    return (buf[:-1].reshape(e, dp * capacity, d), read.reshape(n_tok, k),
            keep.reshape(n_tok, k), gate.reshape(n_tok, k), slot.to(torch.int32),
            aux.mean(), capacity)


def data_shards(n_tok: int) -> int:
    """How many data shards route ``n_tok`` tokens apart: the product of the
    active mesh's data axes, or 1 outside a mesh, when that product is 1, or
    when it does not divide ``n_tok``."""
    # imported here, as in the reference: sharding.py imports the models package
    from repro_torch.distributed.sharding import axis_size, data_axes

    mesh = active_mesh()
    if mesh is None:
        return 1
    dp = axis_size(mesh, data_axes(mesh))
    return dp if dp > 1 and n_tok % dp == 0 else 1


def apply_moe(p: PyTree, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,d) -> (y (B,T,d), aux_loss scalar)."""
    m = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    xf = x.reshape(n_tok, d)
    dt = x.dtype
    dp = data_shards(n_tok)
    if dp > 1:
        # the reference's dispatch shard_map: its inputs as its in_specs lay
        # them out, and its buffer as its out_specs P(None, dp_axes, None)
        # does, each data shard's columns of every expert
        xs = constrain(xf, ("data", None), site="shard_map")
        router = constrain(p["router"], (None, None), site="shard_map")
        buf, read, keep, gate, _, aux, _ = _shard_dispatch_plan(xs, router, m, t, dp)
        buf = constrain(buf, (None, "data", None))
    else:
        buf, slot, gate, aux, cap = _dispatch_combine_plan(xf, p["router"], m, t)
        n_rows = m.n_experts * cap
        read, keep = torch.clamp(slot, max=n_rows - 1).long(), slot < n_rows
    if obs.on and t > 1:  # prefill and training: the capacity drops choices
        obs.count("moe.prefill_choices", n_tok * m.top_k)
        obs.count("moe.prefill_slots", buf.shape[0] * buf.shape[1])
        obs.count_device("moe.prefill_kept", keep)

    xe = constrain(buf, ("model", "data", None))  # EP: experts↔model
    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(dt))
    h = (F.silu(g) if cfg.act == "swiglu" else _gelu(g)) * u
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))  # (E,C,d)
    if dp > 1:  # the inputs of the reference's combine shard_map (in_specs)
        ye = constrain(ye, (None, "data", None), site="shard_map")
        gate = constrain(gate, ("data", None), site="shard_map")

    got = ye.reshape(-1, d)[read]  # (T,k,d)
    w = (gate * keep.to(_F32)).to(got.dtype)
    y = torch.einsum("tkd,tk->td", got, w).to(dt)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, cfg.act)
    return y.reshape(b, t, d), aux
