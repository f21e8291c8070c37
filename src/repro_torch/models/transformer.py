"""Decoder-only LM assembly for configs whose layers are attention + MLP.

The layer list (from ``ModelConfig.layer_specs``) is compiled into *stages*
exactly as in the JAX package: an unrolled prefix of irregular layers plus a
periodic suffix whose parameters and caches are stacked on a leading
``repeat`` axis.  The JAX package scans over that axis; the port loops over
it.  Keeping the stacked layout makes params and caches match the
reference's leaf for leaf, so checkpoints carry over.

Three modes share one code path:
  * ``train``   — full-sequence forward, no cache;
  * ``prefill`` — full-sequence forward, emits per-layer caches;
  * ``decode``  — one new token against the caches.  The port writes this
                  step's key and value into the cache **in place** (the JAX
                  package returns an updated copy that XLA aliases to the
                  donated buffer); attention reads the old slots before the
                  write, as there.

Mamba and MoE layers are not ported yet (ROADMAP Queue 1): a config that
has one raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch

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


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a layer kind the port lacks."""
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer != "attn" or spec.ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {spec.mixer}/{spec.ffn}; the port runs "
                "attention + MLP layers only, Mamba and MoE layers are queued in "
                "ROADMAP.md (Queue 1)"
            )


# ----------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------
def _init_sublayer(gen, cfg, spec, lead: tuple) -> PyTree:
    p: PyTree = {"norm1": init_norm(cfg.norm, cfg.d_model, gen, lead)}
    p["attn"] = attn.init_attention(gen, cfg, lead)
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, gen, lead)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, bias=cfg.mlp_bias, lead=lead)
    return p


def init_stage_params(gen, cfg, stage: Stage) -> PyTree:
    lead = (stage.repeat,) if stage.repeat > 1 else ()
    return tuple(_init_sublayer(gen, cfg, spec, lead) for spec in stage.pattern)


def init_params(gen: torch.Generator, cfg) -> PyTree:
    """Float32 master params on ``gen.device``, drawn from ``gen`` at the
    reference's init scales (the draws differ from ``jax.random``'s)."""
    check_supported(cfg)
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
    check_supported(cfg)
    int8 = cfg.kv_cache_dtype == "int8"
    caches = []
    for st in build_stages(cfg):
        lead = (st.repeat,) if st.repeat > 1 else ()
        entries = []
        for spec in st.pattern:
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
    scale = cfg.hd**-0.5
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
    h_in = apply_norm(cfg.norm, p["norm1"], x)
    h, new_cache = _apply_attn(
        cfg, spec, p["attn"], h_in,
        positions=positions, inv_freq=inv_freq, cache=cache, pos=pos,
        mode=mode, cache_len=cache_len,
    )
    x = x + h
    if spec.ffn != "none":
        x = x + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], x), cfg.act)
    return x, new_cache


# ----------------------------------------------------------------------
# Stage execution (a loop over the periodic suffix)
# ----------------------------------------------------------------------
def _run_stage(cfg, stage: Stage, stage_params, x, *, positions, inv_freq,
               stage_cache, pos, mode, cache_len=None):
    def run_pattern(x, params_list, cache_list):
        new_caches = []
        for j, spec in enumerate(stage.pattern):
            c = cache_list[j] if cache_list is not None else None
            x, nc = _apply_layer(
                cfg, spec, params_list[j], x,
                positions=positions, inv_freq=inv_freq, cache=c, pos=pos,
                mode=mode, cache_len=cache_len,
            )
            new_caches.append(nc)
        return x, tuple(new_caches)

    if stage.repeat == 1:
        return run_pattern(x, stage_params, stage_cache)

    per_rep = []
    for r in range(stage.repeat):
        # views of repeat r: a decode step's in-place cache writes land in
        # the stacked buffers
        params_r = tree_map(lambda a: a[r], stage_params)
        cache_r = tree_map(lambda a: a[r], stage_cache) if stage_cache is not None else None
        x, nc = run_pattern(x, params_r, cache_r)
        per_rep.append(nc)
    if mode == "decode":
        return x, stage_cache
    if mode == "prefill":
        return x, tree_map(lambda *xs: torch.stack(xs), *per_rep)
    return x, None


# ----------------------------------------------------------------------
# Public forward
# ----------------------------------------------------------------------
def embed_inputs(params, cfg, batch: dict, mode: str) -> torch.Tensor:
    dtype = getattr(torch, cfg.compute_dtype)  # "bfloat16" | "float32"
    x = embed(params["embed"], batch["tokens"].long(), dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
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
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch, mode)
    b, t = x.shape[0], x.shape[1]
    dev = x.device
    if mode == "decode":
        pos = int(batch["pos"])  # current absolute position
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    else:
        pos = None
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    inv_freq = (
        torch.from_numpy(rope_freqs(cfg.hd, cfg.rope_theta, cfg.rope_pct)).to(dev)
        if cfg.attn_every
        else None
    )
    new_caches = []
    for i, st in enumerate(build_stages(cfg)):
        st_cache = cache[i] if cache is not None else None
        x, nc = _run_stage(
            cfg, st, params["stages"][i], x,
            positions=positions, inv_freq=inv_freq,
            stage_cache=st_cache, pos=pos, mode=mode, cache_len=cache_len,
        )
        new_caches.append(nc)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = apply_linear(params["lm_head"], x)
    aux = torch.zeros((), dtype=_F32, device=dev)  # no MoE layers: no aux loss
    return logits, (new_caches if mode in ("prefill", "decode") else None), aux
