"""Unified model facade, as in the JAX package.

``model_for(cfg)`` returns a :class:`Model` with
  * ``init(gen)``                         → params tree (on ``gen.device``)
  * ``loss(params, batch)``               → (scalar loss, metrics dict)
  * ``prefill(params, batch, cache_len)`` → (logits, cache)
  * ``decode_step(params, batch, cache)`` → (logits, cache), cache updated in place
  * ``init_cache(batch, max_len, dtype, device)`` → zeroed cache

Every family is ported: the decoder-only ones (dense, MoE, SSM, hybrid,
VLM) through ``transformer``, the encoder-decoder (``audio``) one through
``whisper``, whose batches carry ``frames`` and whose ``prefill`` ignores
``cache_len`` (its self-cache is as long as the prompt, as in the
reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from . import transformer, whisper
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
        total = ce
        if cfg.moe is not None:
            total = total + cfg.moe.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom}

    return loss_fn


def model_for(cfg) -> Model:
    impl = whisper if cfg.family == "audio" else transformer
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
