"""Decoder-only LM assembly covering dense / MoE / SSM / hybrid / VLM.

The layer list (from ``ModelConfig.layer_specs``) is compiled into *stages*
exactly as in the JAX package: an unrolled prefix of irregular layers plus a
periodic suffix whose parameters and caches are stacked on a leading
``repeat`` axis.  The JAX package scans over that axis; the port loops over
it.  Keeping the stacked layout makes params and caches match the
reference's leaf for leaf, so checkpoints carry over.

Three modes share one code path:
  * ``train``   — full-sequence forward, no cache; with ``cfg.remat ==
                  "block"`` each block (each repeat of a stage's pattern)
                  runs under ``torch.utils.checkpoint``, as the reference
                  wraps it in ``jax.checkpoint``;
  * ``prefill`` — full-sequence forward, emits per-layer caches;
  * ``decode``  — one new token against the caches (attention KV ring or
                  full buffers, mamba conv + ssm state).  The port writes
                  the step's key and value, and the mamba layer's new conv
                  and ssm state, into the cache **in place** (the JAX
                  package returns an updated copy that XLA aliases to the
                  donated buffer); attention reads the old slots before the
                  write, as there.

MoE layers return the router's load-balancing loss, summed over layers as
``aux``.  The residual stream and the logits are constrained at the
reference's sites (``distributed/api.py::constrain``): a no-op outside a
``sharding_context``, the tensor itself inside one.  Granite's scalars
(``embedding_multiplier``, ``attention_multiplier``,
``residual_multiplier``, ``logits_scaling``) and NoPE (``rope_pct`` 0)
launch nothing at their defaults.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
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
    rope_freqs,
    unembed,
)
from .mamba2 import apply_mamba, init_mamba, init_mamba_cache
from .moe import apply_moe, init_moe
from .params import tree_map

PyTree = Any
_F32 = torch.float32


# ----------------------------------------------------------------------
# Stage decomposition
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Stage:
    pattern: tuple  # tuple[LayerSpec, ...]
    repeat: int
    first_layer: int  # absolute index of the stage's first layer


@functools.lru_cache(maxsize=64)
def build_stages(cfg) -> list[Stage]:
    specs = cfg.layer_specs()
    n = len(specs)
    best = None  # (suffix_len, -period, start)
    for p in range(1, min(12, n) + 1):
        # longest p-periodic suffix with whole number of repeats
        start = n - p
        while start - p >= 0 and specs[start - p : start] == specs[start : start + p]:
            start -= p
        suffix = n - start
        reps = suffix // p
        if reps >= 1:
            key = (suffix, -p)
            if best is None or key > best[0]:
                best = (key, p, start)
    _, period, start = best
    stages: list[Stage] = []
    for i in range(start):  # irregular prefix: one stage per layer
        stages.append(Stage(pattern=(specs[i],), repeat=1, first_layer=i))
    stages.append(
        Stage(pattern=tuple(specs[start : start + period]),
              repeat=(n - start) // period, first_layer=start)
    )
    return stages


# ----------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------
def _init_sublayer(gen, cfg, spec, lead: tuple) -> PyTree:
    p: PyTree = {"norm1": init_norm(cfg.norm, cfg.d_model, gen, lead)}
    if spec.mixer == "attn":
        p["attn"] = attn.init_attention(gen, cfg, lead)
    else:
        p["mamba"] = init_mamba(gen, cfg, lead)
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, gen, lead)
        if spec.ffn == "moe":
            p["moe"] = init_moe(gen, cfg, lead)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, bias=cfg.mlp_bias,
                                lead=lead)
    return p


def init_stage_params(gen, cfg, stage: Stage) -> PyTree:
    lead = (stage.repeat,) if stage.repeat > 1 else ()
    return tuple(_init_sublayer(gen, cfg, spec, lead) for spec in stage.pattern)


def init_params(gen: torch.Generator, cfg) -> PyTree:
    """Float32 master params on ``gen.device``, drawn from ``gen`` at the
    reference's init scales (the draws differ from ``jax.random``'s)."""
    params: PyTree = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": init_norm(cfg.norm, cfg.d_model, gen),
        "stages": [init_stage_params(gen, cfg, st) for st in build_stages(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size)
    if cfg.vlm is not None:
        params["mm_proj"] = init_linear(gen, cfg.vlm.d_vision, cfg.d_model, bias=True)
    return params


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------
def _attn_cache_shape(cfg, spec, batch: int, max_len: int):
    s = max_len if spec.is_global or cfg.sliding_window is None else min(
        cfg.sliding_window, max_len
    )
    return (batch, cfg.n_kv_heads, s, cfg.hd)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 (..., hd), f32 scale (...,))."""
    x32 = x.to(_F32)
    absmax = x32.abs().amax(dim=-1)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(_F32) * scale[..., None].to(_F32)).to(dtype)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> PyTree:
    """Zeroed caches, one entry per stage mirroring the stage params layout."""
    int8 = cfg.kv_cache_dtype == "int8"
    caches = []
    for st in build_stages(cfg):
        lead = (st.repeat,) if st.repeat > 1 else ()
        entries = []
        for spec in st.pattern:
            if spec.mixer != "attn":
                entries.append(init_mamba_cache(cfg, batch, dtype, device, lead))
                continue
            shape = (*lead, *_attn_cache_shape(cfg, spec, batch, max_len))
            if int8:
                e = {
                    "k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "ks": torch.full(shape[:-1], 1e-12, dtype=_F32, device=device),
                    "vs": torch.full(shape[:-1], 1e-12, dtype=_F32, device=device),
                }
            else:
                e = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
            entries.append(e)
        caches.append(tuple(entries))
    return caches


# ----------------------------------------------------------------------
# Sublayer application
# ----------------------------------------------------------------------
def _apply_attn(cfg, spec, p, x, *, positions, inv_freq, cache, pos, mode,
                cache_len=None):
    h = cfg.n_heads
    rep = h // cfg.n_kv_heads
    scale = cfg.hd**-0.5 if cfg.attention_multiplier is None else cfg.attention_multiplier
    q, k, v = attn.qkv_proj(p, x, cfg, positions, inv_freq)
    window = None if spec.is_global else cfg.sliding_window
    int8 = cfg.kv_cache_dtype == "int8"
    if mode in ("train", "prefill"):
        t = x.shape[1]
        qpos = positions[0]  # (T,) — batch-uniform positions
        o = attn.attention(
            q, attn.repeat_kv(k, rep), attn.repeat_kv(v, rep),
            impl=cfg.attn_impl, q_pos=qpos, k_pos=qpos, window=window,
            scale=scale, chunk=cfg.attn_chunk,
        )
        new_cache = None
        if mode == "prefill":
            cap = cache_len if cache_len is not None else t
            s = _attn_cache_shape(cfg, spec, x.shape[0], cap)[2]
            kk, vv = k[:, :, -s:, :], v[:, :, -s:, :]
            if s > t:  # pad to capacity; future decode steps fill slots t..s
                kk = torch.nn.functional.pad(kk, (0, 0, 0, s - t))
                vv = torch.nn.functional.pad(vv, (0, 0, 0, s - t))
            elif s < t:  # ring layout: key of position p lives at slot p % s
                kk = torch.roll(kk, t % s, dims=2)
                vv = torch.roll(vv, t % s, dims=2)
            if int8:
                kq, ks = _quantize_kv(kk)
                vq, vs = _quantize_kv(vv)
                new_cache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
            else:
                new_cache = {"k": kk.contiguous(), "v": vv.contiguous()}
    else:  # decode: T == 1
        s = cache["k"].shape[2]
        slot = pos % s
        ar = torch.arange(s, device=x.device)
        # ring fully valid once warm; the current slot is stale in the old cache
        valid = torch.ones_like(ar, dtype=torch.bool) if pos >= s else ar <= pos
        valid = valid & (ar != slot)
        if int8:
            k_old = _dequantize_kv(cache["k"], cache["ks"], k.dtype)
            v_old = _dequantize_kv(cache["v"], cache["vs"], v.dtype)
        else:
            k_old, v_old = cache["k"], cache["v"]
        if cfg.gqa_decode == "grouped":
            o = attn.attend_decode_plus_new_gqa(q, k_old, v_old, k, v, valid, scale)
        else:
            o = attn.attend_decode_plus_new(
                q, attn.repeat_kv(k_old, rep), attn.repeat_kv(v_old, rep),
                attn.repeat_kv(k, rep), attn.repeat_kv(v, rep), valid, scale,
            )
        # the write comes after attention has read the old slots
        if int8:
            kq, ks1 = _quantize_kv(k)
            vq, vs1 = _quantize_kv(v)
            cache["k"][:, :, slot] = kq[:, :, 0]
            cache["v"][:, :, slot] = vq[:, :, 0]
            cache["ks"][:, :, slot] = ks1[:, :, 0]
            cache["vs"][:, :, slot] = vs1[:, :, 0]
        else:
            cache["k"][:, :, slot] = k[:, :, 0]
            cache["v"][:, :, slot] = v[:, :, 0]
        new_cache = cache
    return attn.out_proj(p, o), new_cache


def _apply_layer(cfg, spec, p, x, *, positions, inv_freq, cache, pos, mode,
                 cache_len=None):
    aux = torch.zeros((), dtype=_F32, device=x.device)
    h_in = apply_norm(cfg.norm, p["norm1"], x)
    if spec.mixer == "attn":
        h, new_cache = _apply_attn(
            cfg, spec, p["attn"], h_in,
            positions=positions, inv_freq=inv_freq, cache=cache, pos=pos,
            mode=mode, cache_len=cache_len,
        )
    else:
        h, new_cache = apply_mamba(
            p["mamba"], h_in, cfg,
            cache=cache if mode == "decode" else None, chunk=cfg.ssm.chunk,
            prefill_cache=mode == "prefill",
        )
        if mode == "prefill":
            if obs.on:
                obs.count("mamba.prefill_tokens", h_in.shape[0] * h_in.shape[1])
        elif mode == "decode":  # the new conv + ssm state, written in place
            for key, val in new_cache.items():
                cache[key].copy_(val)
            new_cache = cache
    x = _residual(cfg, x, h)
    x = constrain(x, ("data", None, None))
    if spec.ffn != "none":
        h2 = apply_norm(cfg.norm, p["norm2"], x)
        if spec.ffn == "moe":
            h2, a = apply_moe(p["moe"], h2, cfg)
            aux = aux + a
        else:
            h2 = apply_mlp(p["mlp"], h2, cfg.act)
        x = _residual(cfg, x, h2)
        x = constrain(x, ("data", None, None))
    return x, new_cache, aux


def _residual(cfg, x, h):
    """x + h, the branch scaled by ``residual_multiplier`` first."""
    if cfg.residual_multiplier != 1.0:
        h = h * cfg.residual_multiplier
    return x + h


# ----------------------------------------------------------------------
# Stage execution (a loop over the periodic suffix)
# ----------------------------------------------------------------------
def _run_stage(cfg, stage: Stage, stage_params, x, *, positions, inv_freq,
               stage_cache, pos, mode, cache_len=None):
    def run_pattern(x, params_list, cache_list):
        aux = torch.zeros((), dtype=_F32, device=x.device)
        new_caches = []
        for j, spec in enumerate(stage.pattern):
            c = cache_list[j] if cache_list is not None else None
            x, nc, a = _apply_layer(
                cfg, spec, params_list[j], x,
                positions=positions, inv_freq=inv_freq, cache=c, pos=pos,
                mode=mode, cache_len=cache_len,
            )
            new_caches.append(nc)
            aux = aux + a
        return x, tuple(new_caches), aux

    fn = run_pattern
    if cfg.remat == "block" and mode == "train":
        # keep only each block's input; its activations are recomputed in
        # the backward pass (the reference's jax.checkpoint), under the
        # sharding context of the forward
        fn = functools.partial(checkpoint, bind_context(run_pattern), use_reentrant=False)

    if stage.repeat == 1:
        return fn(x, stage_params, stage_cache)

    aux_total = torch.zeros((), dtype=_F32, device=x.device)
    per_rep = []
    for r in range(stage.repeat):
        # views of repeat r: a decode step's in-place cache writes land in
        # the stacked buffers
        params_r = tree_map(lambda a: a[r], stage_params)
        cache_r = tree_map(lambda a: a[r], stage_cache) if stage_cache is not None else None
        x, nc, a = fn(x, params_r, cache_r)
        per_rep.append(nc)
        aux_total = aux_total + a
    if mode == "decode":
        return x, stage_cache, aux_total
    if mode == "prefill":
        return x, tree_map(lambda *xs: torch.stack(xs), *per_rep), aux_total
    return x, None, aux_total


# ----------------------------------------------------------------------
# Public forward
# ----------------------------------------------------------------------
def embed_inputs(params, cfg, batch: dict, mode: str) -> torch.Tensor:
    dtype = getattr(torch, cfg.compute_dtype)  # "bfloat16" | "float32"
    x = embed(params["embed"], batch["tokens"].long(), dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.vlm is not None and "patch_embeds" in batch:
        vis = apply_linear(params["mm_proj"], batch["patch_embeds"].to(dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def forward(
    params: PyTree,
    cfg,
    batch: dict,  # tokens (B,T) [+ patch_embeds]; decode: tokens (B,1), pos int
    *,
    mode: str,  # train | prefill | decode
    cache: Optional[list] = None,
    cache_len: Optional[int] = None,  # prefill: pad caches to this capacity
) -> tuple[torch.Tensor, Optional[list], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss). Logits (B,T,V)."""
    x = embed_inputs(params, cfg, batch, mode)
    x = constrain(x, ("data", None, None))
    b, t = x.shape[0], x.shape[1]
    dev = x.device
    if mode == "decode":
        pos = int(batch["pos"])  # current absolute position
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    else:
        pos = None
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    inv_freq = (  # None: no rotary at all (attention-free, or NoPE)
        torch.from_numpy(rope_freqs(cfg.hd, cfg.rope_theta, cfg.rope_pct)).to(dev)
        if cfg.attn_every and cfg.rope_pct > 0
        else None
    )
    aux = torch.zeros((), dtype=_F32, device=dev)
    new_caches = []
    for i, st in enumerate(build_stages(cfg)):
        st_cache = cache[i] if cache is not None else None
        x, nc, a = _run_stage(
            cfg, st, params["stages"][i], x,
            positions=positions, inv_freq=inv_freq,
            stage_cache=st_cache, pos=pos, mode=mode, cache_len=cache_len,
        )
        new_caches.append(nc)
        aux = aux + a
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = apply_linear(params["lm_head"], x)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    logits = constrain(logits, ("data", None, "model"))
    return logits, (new_caches if mode in ("prefill", "decode") else None), aux
