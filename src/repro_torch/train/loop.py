"""Training loop with checkpoint/restart fault tolerance.

``run_train`` drives the train step over the synthetic pipeline on
``device`` (the card unless the caller asks for the CPU), checkpointing
every ``ckpt_every`` steps in the FaaSNet block format (with optional
asynchronous writes).  ``fail_at_step`` raises a simulated hard failure;
calling ``run_train`` again with the same directory resumes from the latest
complete checkpoint, and the restarted run reproduces the uninterrupted
loss trajectory.  Checkpoints hold the JAX package's tree
(``{"params", "opt"}``, same leaf paths and dtypes), so a run started by
either package resumes in the other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: dict[int, float] = field(default_factory=dict)
    wall_s: float = 0.0
    resumed_from: Optional[int] = None


def run_train(
    cfg,
    *,
    steps: int,
    seq_len: int = 256,
    batch: int = 8,
    n_micro: int = 1,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    async_save: bool = False,
    fail_at_step: Optional[int] = None,
    opt: AdamWConfig | None = None,
    seed: int = 0,
    log_every: int = 10,
    mesh=None,
    device="cuda",
) -> TrainResult:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_train(device='cuda'): CUDA is not available; "
            "pass device='cpu' to train on the CPU"
        )
    opt = opt or AdamWConfig(warmup_steps=10, total_steps=steps)
    _, train_step = make_train_step(cfg, mesh, opt=opt, n_micro=n_micro)

    mgr = (
        CheckpointManager(ckpt_dir, async_save=async_save)
        if ckpt_dir is not None
        else None
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    params, opt_state = init_train_state(cfg, gen)
    start_step = 0
    resumed_from = None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, {"params": params, "opt": opt_state}, device=device)
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            resumed_from = latest

    res = TrainResult(steps_run=0, final_step=start_step, resumed_from=resumed_from)
    t0 = time.monotonic()
    for step in range(start_step, steps):
        b = make_batch(cfg, seq_len, batch, kind="train", seed=seed * 100_003 + step,
                       device=device)
        params, opt_state, metrics = train_step(params, opt_state, b)
        res.steps_run += 1
        res.final_step = step + 1
        if (step + 1) % log_every == 0 or step + 1 == steps:
            res.losses[step + 1] = float(metrics["loss"])
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
        if fail_at_step is not None and step + 1 == fail_at_step:
            if mgr is not None:
                mgr.wait()
            res.wall_s = time.monotonic() - t0
            raise SimulatedFailure(f"injected failure at step {step + 1}")
    if mgr is not None:
        mgr.wait()
    res.wall_s = time.monotonic() - t0
    return res
