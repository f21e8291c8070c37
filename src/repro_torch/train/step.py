"""Train-step factory: microbatched gradient accumulation and AdamW.

``make_train_step(cfg, mesh, ...)`` builds
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``,
the JAX package's step:

  * gradient accumulation over ``n_micro`` microbatches, each through
    ``model.loss`` and ``torch.autograd`` (activation memory bounded by the
    microbatch, not the global batch), summed in float32 and divided by
    ``n_micro``;
  * AdamW on the float32 master weights (``optim.adamw``, in place), and the
    new params as the master weights cast to the params' dtype;
  * with a ``mesh``, the reference's ZeRO-1 layout: each microbatch's
    float32 gradients and the accumulator constrained to
    ``ShardingRules.opt_shardings``, the new params to
    ``params_shardings`` (``distributed/api.py::with_sharding_constraint``,
    which on one card leaves every tensor whole: outside a sharding
    context the values are the ``mesh=None`` step's bit for bit; each
    call names its site, ``"grad_accumulator"``, ``"grad"`` or
    ``"params"``, for ``launch/dryrun.py``'s collective model).

As in the reference, the step does not enter a ``sharding_context``; the
caller does, and inside one the MoE layers route each data shard's tokens
on their own (``models/moe.py``).  ``opt_state`` is updated in place and
returned, where the JAX package donates it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.api import with_sharding_constraint
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import model_for
from repro_torch.models.params import tree_leaves_with_path, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

PyTree = Any


def _split_microbatches(batch: dict, n_micro: int) -> list[dict]:
    def split(x, i):
        if x.dim() == 0:
            return x
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} is not a multiple of n_micro={n_micro}")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])[i]

    return [{k: split(v, i) for k, v in batch.items()} for i in range(n_micro)]


def make_train_step(cfg, mesh=None, *, opt: AdamWConfig | None = None,
                    n_micro: int = 1):
    opt = opt or AdamWConfig()
    model = model_for(cfg)
    rules = ShardingRules(cfg, mesh) if mesh is not None else None
    layouts: dict = {}  # (path, shape) of every leaf -> (opt specs, params specs)

    def leaf_layouts(params, pairs):
        """The ZeRO-1 layout of the gradients and their float32 accumulator,
        and the params' layout, leaf by leaf; they depend on the leaves'
        paths and shapes alone, so each tree is walked once."""
        key = tuple((path, tuple(p.shape)) for path, p in pairs)
        if key not in layouts:
            layouts[key] = tuple([s for _, s in tree_leaves_with_path(walk(params))]
                                 for walk in (rules.opt_shardings, rules.params_shardings))
        return layouts[key]

    def train_step(params, opt_state, batch):
        pairs = tree_leaves_with_path(params)
        leaves = [p for _, p in pairs]
        device = leaves[0].device
        opt_spec, params_spec = (leaf_layouts(params, pairs) if rules is not None
                                 else ([None] * len(leaves), None))

        def shard_like_opt(g, spec, site):
            # as the reference, in float32: its ZeRO-1 reduce-scatter moves f32
            return (g if spec is None or g is None
                    else with_sharding_constraint(g.to(torch.float32), spec, site=site))

        g_acc = [shard_like_opt(torch.zeros(p.shape, dtype=torch.float32, device=device), s,
                                "grad_accumulator")
                 for p, s in zip(leaves, opt_spec)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for mb in _split_microbatches(batch, n_micro):
            with torch.enable_grad():
                live = [p.detach().requires_grad_() for p in leaves]
                loss, metrics = model.loss(tree_unflatten(params, live), mb)
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            with torch.no_grad():
                for acc, g, spec in zip(g_acc, grads, opt_spec):
                    if g is not None:  # a leaf the loss does not use: a zero gradient
                        acc.add_(shard_like_opt(g, spec, "grad"))  # added in float32
                loss_sum = loss_sum + loss.detach()
            ce_last = metrics["ce"].detach()
        with torch.no_grad():
            grads = tree_unflatten(params, [g.div_(n_micro) for g in g_acc])
            del g_acc, live
            new_master, new_opt, om = adamw_update(opt, grads, opt_state)
            del grads  # the f32 accumulator, freed before the new params are cast
            new_params = tree_map(lambda m, p: m.to(p.dtype, copy=True), new_master, params)
            if rules is not None:
                new_params = tree_unflatten(new_params, [
                    with_sharding_constraint(x, spec, site="params")
                    for (_, x), spec in zip(tree_leaves_with_path(new_params), params_spec)])
        metrics = {"loss": loss_sum / n_micro, "ce_last": ce_last, **om}
        return new_params, new_opt, metrics

    return model, train_step


def init_train_state(cfg, gen: torch.Generator):
    """Params (compute dtype) and optimizer state, on ``gen.device``."""
    model = model_for(cfg)
    params = model.init(gen)
    dtype = getattr(torch, cfg.compute_dtype)
    params_c = tree_map(lambda p: p.to(dtype, copy=True), params)
    opt_state = init_opt_state(params)
    return params_c, opt_state
