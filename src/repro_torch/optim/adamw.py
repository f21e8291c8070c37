"""AdamW + schedules + global-norm clipping, on tensor trees.

The optimizer state is the JAX package's tree ``{"m", "v", "master",
"step"}``: float32 moments and master weights shaped like the params, and a
0-d int32 ``step``, so a state written by either package's checkpoint
manager restores in the other.  ``adamw_update`` keeps the reference's
float32 expression order, and the leaf order of the ``global_norm`` sum, and
updates ``m``, ``v``, ``master`` and ``step`` **in place** under
``torch.no_grad()``: the JAX package donates those buffers to its jitted
step instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.params import tree_leaves_with_path, tree_map

PyTree = Any
_F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(_F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: PyTree) -> PyTree:
    """Zero moments, a float32 copy of ``params`` as master, step 0 (on
    the params' device)."""
    leaves = tree_leaves_with_path(params)
    device = leaves[0][1].device if leaves else "cpu"
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(_F32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(_F32))) for _, x in tree_leaves_with_path(tree))
    )


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads: PyTree, state: PyTree
) -> tuple[PyTree, PyTree, dict]:
    """Returns (new master params, new state, metrics); ``state``'s tensors
    are updated in place and returned."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(_F32)
    b2c = 1 - cfg.b2 ** step.to(_F32)

    def upd(g, m, v, p):
        g = g.to(_F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        p.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p))

    flat = [
        [x for _, x in tree_leaves_with_path(t)]
        for t in (grads, state["m"], state["v"], state["master"])
    ]
    for g, m, v, p in zip(*flat):
        upd(g, m, v, p)
    state["step"].copy_(step)
    return state["master"], state, {"grad_norm": gnorm, "lr": lr}
