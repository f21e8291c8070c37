"""Synthetic batch generation shared by smoke tests, examples and the train loop.

``make_batch`` builds a real (materialized) batch for a config+shape and puts
it on ``device``; ``batch_specs`` gives the matching shapes and dtypes as
tensors on the ``meta`` device (no allocation).  The two must stay in
lock-step.  The draws come from ``np.random.default_rng(seed)`` in the JAX
package's order, so every array equals the JAX package's bit for bit
(bf16 rounded to nearest even in both).
"""
from __future__ import annotations

import numpy as np
import torch


def _text_len(cfg, seq_len: int) -> int:
    if cfg.vlm is not None:
        return seq_len - cfg.vlm.n_patches
    return seq_len


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def _i32(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int32)).to(device)


def make_batch(cfg, seq_len: int, batch: int, *, kind: str, seed: int = 0,
               device="cuda") -> dict:
    rng = np.random.default_rng(seed)
    out: dict = {}
    if kind in ("train", "prefill"):
        t_text = _text_len(cfg, seq_len)
        # Additive-walk sequences: x[t+1] = (x[t] + 1) mod V with a random
        # per-row start.  Marginally uniform over the vocab, but next-token
        # prediction has real signal, so "loss goes down" tests measure
        # learning rather than luck (iid labels bound the loss at ln V).
        start = rng.integers(0, cfg.vocab_size, (batch, 1))
        seq = (start + np.arange(seq_len + 1)[None, :]) % cfg.vocab_size
        out["tokens"] = _i32(seq[:, :t_text], device)
        if cfg.vlm is not None:
            out["patch_embeds"] = _bf16(
                rng.standard_normal((batch, cfg.vlm.n_patches, cfg.vlm.d_vision)), device
            )
        if cfg.encdec is not None:
            e = cfg.encdec
            out["frames"] = _bf16(
                rng.standard_normal((batch, e.encoder_ctx, e.d_frontend)), device
            )
        if kind == "train":
            out["labels"] = _i32(seq[:, 1:], device)
    else:  # decode
        out["tokens"] = _i32(rng.integers(0, cfg.vocab_size, (batch, 1)), device)
        out["pos"] = torch.tensor(seq_len - 1, dtype=torch.int32, device=device)
    return out


def batch_specs(cfg, seq_len: int, batch: int, *, kind: str) -> dict:
    """``make_batch``'s shapes and dtypes, as tensors on the ``meta`` device."""
    bf16, i32 = torch.bfloat16, torch.int32

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if kind in ("train", "prefill"):
        t_text = _text_len(cfg, seq_len)
        out["tokens"] = spec((batch, t_text), i32)
        if cfg.vlm is not None:
            out["patch_embeds"] = spec((batch, cfg.vlm.n_patches, cfg.vlm.d_vision), bf16)
        if cfg.encdec is not None:
            e = cfg.encdec
            out["frames"] = spec((batch, e.encoder_ctx, e.d_frontend), bf16)
        if kind == "train":
            out["labels"] = spec((batch, seq_len), i32)
    else:
        out["tokens"] = spec((batch, 1), i32)
        out["pos"] = spec((), i32)
    return out


def token_stream(cfg, seq_len: int, batch: int, *, seed: int = 0, device="cuda"):
    """Infinite deterministic token batches for the training examples."""
    step = 0
    while True:
        yield make_batch(cfg, seq_len, batch, kind="train", seed=seed + step, device=device)
        step += 1
