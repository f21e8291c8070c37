"""Expert positions of the MoE router (CUDA on Hopper).

``route_topk`` (``models/moe.py``) gives each (token, choice) a row of its
expert's capacity buffer: with ``e`` the choice's expert and ``pos`` the
number of earlier choices of ``e`` in the flattened token-major order,
``slot = e·C + pos`` where ``pos < C`` and ``E·C`` (dropped) otherwise.
``expert_slots`` computes it for ``L`` independent routings at once (1 on
one device, one per data shard under a mesh): ``(L, n, k)`` int32 expert ids
in, ``(L, n, k)`` int32 slots out.

This replaces no Pallas kernel: the JAX package takes ``jnp.cumsum`` over a
one-hot matrix, which XLA fuses.  Its plain PyTorch translation,
``expert_slots_torch``, scans an int64 (n·k, E) matrix down its rows with
one thread per expert, which took ~27 ms a layer at granite_moe_1b's full
batch on an H100.  The kernel (``csrc/moe_route.cu``) is a deterministic
counting scan in token order (no atomics decide a position), so the same
choices drop as with the plain version, bit for bit.  Its bound is 8 bytes
a choice (the ids in, the slots out): the launches set its time.

``expert_slots`` takes the plain version for a CPU tensor (and a ``meta``
one, which the dry runs trace) and launches the kernel for a CUDA tensor;
what the kernel does not take raises ``ValueError``
(``check_kernel_operands``), and a failed build or launch raises: there is
no fallback.  It launches on the current stream, allocates
with ``torch.empty`` and does not synchronise.  Each call on either route
opens the span ``kernels.moe_route``; each kernel call adds one to
``expert_slots.launches``.  The slots are integers and carry no gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs

__all__ = [
    "MAX_EXPERTS",
    "check_kernel_operands",
    "expert_slots",
    "expert_slots_torch",
    "reset_launches",
]

MAX_EXPERTS = 256  # csrc/moe_route.cu's kMaxExperts; the configs use 4-64


def expert_slots_torch(eids: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """The plain version: a cumsum down the one-hot matrix of the choices."""
    *lead, t, k = eids.shape
    onehot = F.one_hot(eids.long(), n_experts)  # (...,T,k,E) int64
    flat = onehot.reshape(*lead, t * k, n_experts)
    pos_in_expert = (torch.cumsum(flat, dim=-2) - flat).reshape(*lead, t, k, n_experts)
    pos = (pos_in_expert * onehot).sum(-1)  # (...,T,k)
    keep = pos < capacity
    slot = torch.where(keep, eids.long() * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return slot.to(torch.int32)


def check_kernel_operands(eids: torch.Tensor, n_experts: int, capacity: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes these operands."""
    if eids.dtype != torch.int32:
        raise ValueError(f"eids must be int32, got {eids.dtype}")
    if eids.dim() != 3:
        raise ValueError(f"eids must be (L, n, k), got shape {tuple(eids.shape)}")
    if not eids.is_contiguous():
        raise ValueError("eids must be contiguous")
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"{n_experts} experts; the kernel takes 1 to {MAX_EXPERTS}")
    if capacity < 0 or n_experts * capacity >= 2**31:
        raise ValueError(f"capacity {capacity} x {n_experts} experts does not fit int32 slots")
    if eids.shape[0] > 65535:
        raise ValueError(f"{eids.shape[0]} routings; the kernel takes at most 65535")


def expert_slots(eids: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """``(L, n, k)`` int32 expert ids -> ``(L, n, k)`` int32 slots into ``E·C``."""
    l, n, k = eids.shape
    with obs.span("kernels.moe_route", tokens=l * n, k=k, e=n_experts, capacity=capacity):
        if eids.device.type in ("cpu", "meta"):  # meta: the dry runs' traces
            return expert_slots_torch(eids, n_experts, capacity)
        if eids.device.type != "cuda":
            raise ValueError(f"expert_slots runs on cpu, meta or cuda, not {eids.device}")
        check_kernel_operands(eids, n_experts, capacity)
        from ._build import library

        slot = torch.empty_like(eids)
        if eids.numel() == 0:
            return slot
        lib = library("moe_route")
        tiles = -(-n * k // lib.repro_expert_slots_tile())
        counts = torch.empty(l * tiles * n_experts if tiles > 1 else 0, dtype=torch.int32,
                             device=eids.device)
        with torch.cuda.device(eids.device):
            rc = lib.repro_expert_slots(
                eids.data_ptr(), slot.data_ptr(), counts.data_ptr(), l, n * k, n_experts,
                capacity, torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"expert_slots kernel launch failed: CUDA error {rc}")
        expert_slots.launches += 1
        return slot


def reset_launches() -> None:
    """Set the wrapper's launch count to 0."""
    expert_slots.launches = 0


reset_launches()
