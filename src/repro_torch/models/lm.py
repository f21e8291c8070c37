"""Unified model facade, as in the JAX package.

``model_for(cfg)`` returns a :class:`Model` with
  * ``init(gen)``                         → params tree (on ``gen.device``)
  * ``loss(params, batch)``               → (scalar loss, metrics dict)
  * ``prefill(params, batch, cache_len)`` → (logits, cache)
  * ``decode_step(params, batch, cache)`` → (logits, cache), cache updated in place
  * ``init_cache(batch, max_len, dtype, device)`` → zeroed cache

Decoder-only configs whose layers are attention + MLP are ported; the
encoder-decoder (``audio``) family and Mamba/MoE layers raise
``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from . import transformer as impl
from .layers import softmax_xent

PyTree = Any


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _lm_loss(forward, cfg):
    def loss_fn(params, batch):
        logits, _, aux = forward(params, cfg, batch, mode="train")
        labels = batch["labels"]
        mask = labels >= 0
        safe = torch.where(mask, labels, torch.zeros_like(labels))
        per_tok = softmax_xent(logits, safe, z_loss=cfg.z_loss)
        denom = torch.clamp(mask.sum(), min=1)
        ce = torch.where(mask, per_tok, torch.zeros_like(per_tok)).sum() / denom
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    return loss_fn


def model_for(cfg) -> Model:
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (audio) family is not ported yet; "
            "it is queued in ROADMAP.md (Queue 1)"
        )
    impl.check_supported(cfg)
    fwd = impl.forward

    def init(gen: torch.Generator):
        return impl.init_params(gen, cfg)

    @torch.no_grad()
    def prefill(params, batch, cache_len=None):
        logits, cache, _ = fwd(params, cfg, batch, mode="prefill", cache_len=cache_len)
        return logits, cache

    @torch.no_grad()
    def decode_step(params, batch, cache):
        logits, cache, _ = fwd(params, cfg, batch, mode="decode", cache=cache)
        return logits, cache

    def init_cache(batch, max_len, dtype=torch.bfloat16, device="cuda"):
        return impl.init_cache(cfg, batch, max_len, dtype, device)

    return Model(cfg, init, _lm_loss(fwd, cfg), prefill, decode_step, init_cache)
