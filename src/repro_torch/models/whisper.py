"""Whisper-style encoder-decoder backbone (audio frontend is a STUB).

As in the JAX package: the conv frontend is stubbed, so a batch feeds
precomputed frame embeddings (B, encoder_ctx, d_frontend) and a learned
input projection maps them to d_model.  The decoder is a causal transformer
with per-layer cross-attention over the encoder output.  Positional
encodings are sinusoidal for both stacks.

The stacked layers keep the reference's layout (a leading layer axis on
every leaf of ``enc_layers`` and ``dec_layers``), so params, caches and
checkpoints match it leaf for leaf.  The JAX package scans over that axis;
the port loops over it.  The encoder's and the decoder's residual streams
and the logits are constrained at the reference's sites
(``distributed/api.py::constrain``): a no-op outside a
``sharding_context``, the tensor itself inside one.

Three modes, as there:
  * ``train``   — full-sequence forward, no cache; with ``cfg.remat ==
                  "block"`` each decoder layer runs under
                  ``torch.utils.checkpoint`` (the encoder does not);
  * ``prefill`` — runs the encoder, the per-layer cross K/V and the
                  decoder over the prompt; the self-attention cache is the
                  prompt's own K/V, as long as the prompt;
  * ``decode``  — one token against the caches.  The self-cache is a ring
                  of the prompt's length: the step writes slot ``pos % S``
                  **in place**, after attention has read the old slots
                  (the reference returns an updated copy).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.api import bind_context, constrain

from . import attention as attn
from .layers import (
    apply_linear,
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_linear,
    init_mlp,
    init_norm,
    unembed,
)
from .params import tree_map

PyTree = Any
_F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _sinusoid_freqs(dim: int, device: torch.device) -> torch.Tensor:
    """The float32 frequencies of ``sinusoid``, computed on the CPU and moved
    once per (dim, device), so that every device adds the same ones (one ulp
    of a frequency moves the angle at encoder position 1500 by ~1e-4) and no
    call pays a blocking host-to-device copy."""
    half = dim // 2
    ar = torch.arange(half, dtype=_F32)
    return torch.exp(-math.log(10000.0) * ar / max(half - 1, 1)).to(device)


def sinusoid(positions: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """positions (...,) -> (..., dim) classic transformer sinusoids."""
    freqs = _sinusoid_freqs(dim, positions.device)
    ang = positions[..., None].to(_F32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _init_enc_layer(gen, cfg, lead: tuple) -> PyTree:
    d = cfg.d_model
    return {
        "norm1": init_norm(cfg.norm, d, gen, lead),
        "attn": attn.init_attention(gen, cfg, lead),
        "norm2": init_norm(cfg.norm, d, gen, lead),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, bias=cfg.mlp_bias, lead=lead),
    }


def _init_dec_layer(gen, cfg, lead: tuple) -> PyTree:
    d = cfg.d_model
    return {
        "norm1": init_norm(cfg.norm, d, gen, lead),
        "self_attn": attn.init_attention(gen, cfg, lead),
        "norm_x": init_norm(cfg.norm, d, gen, lead),
        "cross_attn": attn.init_attention(gen, cfg, lead),
        "norm2": init_norm(cfg.norm, d, gen, lead),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, bias=cfg.mlp_bias, lead=lead),
    }


def init_params(gen: torch.Generator, cfg) -> PyTree:
    """Float32 master params on ``gen.device``, drawn from ``gen`` at the
    reference's init scales (the draws differ from ``jax.random``'s)."""
    e = cfg.encdec
    return {
        "frontend_proj": init_linear(gen, e.d_frontend, cfg.d_model, bias=True),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "enc_layers": _init_enc_layer(gen, cfg, (e.encoder_layers,)),
        "enc_norm": init_norm(cfg.norm, cfg.d_model, gen),
        "dec_layers": _init_dec_layer(gen, cfg, (cfg.n_layers,)),
        "final_norm": init_norm(cfg.norm, cfg.d_model, gen),
    }


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree_map(lambda a: a[i], stacked)


# ----------------------------------------------------------------------
def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, ctx, d_frontend) -> (B, ctx, d_model)."""
    dtype = getattr(torch, cfg.compute_dtype)
    x = apply_linear(params["frontend_proj"], frames.to(dtype))
    ctx_pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoid(ctx_pos, cfg.d_model, dtype)[None]
    x = constrain(x, ("data", None, None))
    scale = cfg.hd**-0.5
    rep = cfg.n_heads // cfg.n_kv_heads
    for i in range(cfg.encdec.encoder_layers):
        p = _layer(params["enc_layers"], i)
        h = apply_norm(cfg.norm, p["norm1"], x)
        q, k, v = attn.qkv_proj(p["attn"], h, cfg, None, None)
        o = attn.attend_full(q, attn.repeat_kv(k, rep), attn.repeat_kv(v, rep), None, scale)
        x = x + attn.out_proj(p["attn"], o)
        h = apply_norm(cfg.norm, p["norm2"], x)
        x = x + apply_mlp(p["mlp"], h, cfg.act)
        x = constrain(x, ("data", None, None))
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _dec_layer(cfg, p, x, enc_kv, *, positions, self_cache, pos, mode):
    scale = cfg.hd**-0.5
    rep = cfg.n_heads // cfg.n_kv_heads
    # self-attention (causal); sinusoidal positions were added at the
    # embedding, so there is no RoPE here
    h = apply_norm(cfg.norm, p["norm1"], x)
    q, k, v = attn.qkv_proj(p["self_attn"], h, cfg, None, None)
    if mode == "decode":
        s = self_cache["k"].shape[2]
        slot = pos % s
        ar = torch.arange(s, device=x.device)
        valid = ((ar <= pos) | (pos >= s)) & (ar != slot)
        o = attn.attend_decode_plus_new(
            q, attn.repeat_kv(self_cache["k"], rep), attn.repeat_kv(self_cache["v"], rep),
            attn.repeat_kv(k, rep), attn.repeat_kv(v, rep), valid, scale,
        )
        # the write comes after attention has read the old slots
        self_cache["k"][:, :, slot] = k[:, :, 0]
        self_cache["v"][:, :, slot] = v[:, :, 0]
        new_cache = self_cache
    else:
        qpos = positions[0]
        o = attn.attention(q, attn.repeat_kv(k, rep), attn.repeat_kv(v, rep),
                           impl=cfg.attn_impl, q_pos=qpos, k_pos=qpos,
                           window=None, scale=scale, chunk=cfg.attn_chunk)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    x = x + attn.out_proj(p["self_attn"], o)
    # cross-attention over the encoder output (precomputed per-layer K/V);
    # the query takes no bias, as in the reference (``bq`` stays unused)
    h = apply_norm(cfg.norm, p["norm_x"], x)
    qx = torch.einsum("btd,dhk->bhtk", h, p["cross_attn"]["wq"].to(h.dtype))
    kx, vx = enc_kv
    ox = attn.attend_full(qx, attn.repeat_kv(kx, rep), attn.repeat_kv(vx, rep), None, scale)
    x = x + attn.out_proj(p["cross_attn"], ox)
    h = apply_norm(cfg.norm, p["norm2"], x)
    x = x + apply_mlp(p["mlp"], h, cfg.act)
    return constrain(x, ("data", None, None)), new_cache


def cross_kv(params, cfg, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-decoder-layer cross K/V, stacked (L, B, Hkv, ctx, hd)."""
    dt = enc_out.dtype
    wk = params["dec_layers"]["cross_attn"]["wk"]
    wv = params["dec_layers"]["cross_attn"]["wv"]
    ks = [torch.einsum("bsd,dhk->bhsk", enc_out, wk[i].to(dt)) for i in range(cfg.n_layers)]
    vs = [torch.einsum("bsd,dhk->bhsk", enc_out, wv[i].to(dt)) for i in range(cfg.n_layers)]
    return torch.stack(ks), torch.stack(vs)


def forward(
    params, cfg, batch: dict, *, mode: str, cache: Optional[dict] = None,
    cache_len: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """batch: tokens (B,T) [+ frames (B,ctx,d_frontend)]; decode adds pos.

    ``cache_len`` is taken for the facade's sake and ignored, as in the
    reference: the prefill's self-cache is the prompt's own K/V.

    Returns (logits, cache, aux).  Cache = {"self": {"k", "v"} each
    (L,B,Hkv,S,hd), "cross": (kx, vx) each (L,B,Hkv,ctx,hd)}.
    """
    dtype = getattr(torch, cfg.compute_dtype)
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    if mode == "decode":
        pos = int(batch["pos"])
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        kx, vx = cache["cross"]
    else:
        pos = None
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
        kx, vx = cross_kv(params, cfg, encode(params, cfg, batch["frames"]))

    x = embed(params["embed"], tokens.long(), dtype)
    x = x + sinusoid(positions, cfg.d_model, dtype)
    x = constrain(x, ("data", None, None))

    layer_fn = functools.partial(_dec_layer, cfg, positions=positions, pos=pos, mode=mode)
    dec = params["dec_layers"]
    if mode == "decode":
        for i in range(cfg.n_layers):
            # views of layer i: the in-place write lands in the stacked cache
            sc = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
            x, _ = layer_fn(_layer(dec, i), x, (kx[i], vx[i]), self_cache=sc)
        new_self = cache["self"]
    else:
        def run(x, p, enc_kv):
            return layer_fn(p, x, enc_kv, self_cache=None)

        if cfg.remat == "block" and mode == "train":
            # keep only each decoder layer's input; its activations are
            # recomputed in the backward pass (the reference's jax.checkpoint),
            # under the sharding context of the forward
            run = functools.partial(checkpoint, bind_context(run), use_reentrant=False)
        per_layer = []
        for i in range(cfg.n_layers):
            x, nc = run(x, _layer(dec, i), (kx[i], vx[i]))
            per_layer.append(nc)
        new_self = (tree_map(lambda *xs: torch.stack(xs), *per_layer)
                    if mode == "prefill" else None)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = unembed(params["embed"], x)  # whisper ties embeddings
    logits = constrain(logits, ("data", None, "model"))
    aux = torch.zeros((), dtype=_F32, device=dev)
    if mode == "train":
        return logits, None, aux
    return logits, {"self": new_self, "cross": (kx, vx)}, aux


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    e = cfg.encdec
    n, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((n, batch, hkv, s, hd), dtype=dtype, device=device)

    return {
        "self": {"k": zeros(max_len), "v": zeros(max_len)},
        "cross": (zeros(e.encoder_ctx), zeros(e.encoder_ctx)),
    }
