"""Model/arch configuration schema + registry.

Every assigned architecture provides ``src/repro_torch/configs/<id>.py`` exposing
``CONFIG`` (exact published shape) and ``SMOKE`` (reduced same-family config
for CPU tests).  ``repro_torch.configs.get(name)`` returns them.

The layer pattern is described declaratively so one assembly routine
(repro_torch.models.transformer) covers dense / MoE / SSM / hybrid / local-global
families: layer ``i`` gets
  * mixer  = attn  if attn_every and i % attn_every == attn_offset else mamba
  * global = True  if global_every and (i+1) % global_every == 0 (else local
             sliding window when sliding_window is set)
  * ffn    = none  if d_ff == 0 and no moe;
             moe   if moe and i >= moe_first_dense and
                     (i - moe_offset) % moe_every == 0;
             mlp   otherwise
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1  # every k-th layer is MoE
    moe_offset: int = 0
    moe_first_dense: int = 0  # first k layers use dense MLP (DeepSeek-MoE)
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    n_heads: int
    head_dim: int
    d_state: int
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    # precision of the intra-chunk SSD tensors (decay matrix, dtx, partial
    # products); the inter-chunk state recurrence is always f32
    intra_dtype: str = "f32"  # f32 | bf16


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    encoder_ctx: int  # frames after the (stubbed) conv frontend
    d_frontend: int  # frontend feature dim fed by input_specs


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int  # patch embeddings per sample (anyres tiling stub)
    d_vision: int  # vision tower output dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    # layer pattern
    attn_every: int = 1  # 0 => attention-free
    attn_offset: int = 0
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None  # gemma3: 6 => 5 local : 1 global
    # components
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # flavour
    norm: str = "rmsnorm"
    act: str = "swiglu"
    attn_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_pct: float = 1.0
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    # numerics / impl
    compute_dtype: str = "bfloat16"
    attn_impl: str = "chunked"  # full | chunked | pallas
    attn_chunk: int = 1024
    remat: str = "block"  # none | block
    z_loss: float = 0.0
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (quantized decode cache)
    # decode GQA: "repeat" materializes H heads from the cache (baseline);
    # "grouped" keeps the Hkv axis so a sequence-sharded cache never
    # reshards (§Perf hillclimb B)
    gqa_decode: str = "repeat"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_specs(self) -> list["LayerSpec"]:
        specs = []
        for i in range(self.n_layers):
            if self.attn_every and (i % self.attn_every) == self.attn_offset:
                mixer = "attn"
            elif self.ssm is not None:
                mixer = "mamba"
            else:
                mixer = "attn"
            is_global = True
            if self.sliding_window is not None:
                if self.global_every:
                    is_global = (i + 1) % self.global_every == 0
                else:
                    is_global = False
            if self.moe is not None and i >= self.moe.moe_first_dense and (
                (i - self.moe.moe_offset) % self.moe.moe_every == 0
            ):
                ffn = "moe"
            elif self.d_ff > 0:
                ffn = "mlp"
            else:
                ffn = "none"
            specs.append(LayerSpec(mixer=mixer, is_global=is_global, ffn=ffn))
        return specs

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for spec in self.layer_specs():
            n += d  # norm1
            if spec.mixer == "attn":
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                n += self.n_heads * hd * d
            else:
                s = self.ssm
                hp = s.n_heads * s.head_dim
                n += 2 * d * hp + 2 * d * s.n_groups * s.d_state + d * s.n_heads
                n += s.conv_width * (hp + 2 * s.n_groups * s.d_state)
                n += hp * d + hp + 3 * s.n_heads
            if spec.ffn == "mlp":
                n += d  # norm2
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            elif spec.ffn == "moe":
                n += d
                m = self.moe
                n += d * m.n_experts  # router
                n += m.n_experts * 3 * d * m.d_expert
                if m.n_shared:
                    n += 3 * d * (m.d_expert * m.n_shared)
        n += d  # final norm
        if self.encdec is not None:
            e = self.encdec
            per_enc = d + 2 * (d * self.n_heads * hd + d) + d + 2 * d * self.d_ff
            n += e.encoder_layers * per_enc  # rough: enc self-attn + mlp
            n += self.n_layers * (d + 2 * d * self.n_kv_heads * hd + d * self.n_heads * hd + self.n_heads * hd * d)  # cross-attn
        if self.vlm is not None:
            n += self.vlm.d_vision * d + d  # mm projector
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        all_experts = n_moe_layers * m.n_experts * 3 * self.d_model * m.d_expert
        active = n_moe_layers * m.top_k * 3 * self.d_model * m.d_expert
        return full - all_experts + active


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mamba
    is_global: bool
    ffn: str  # mlp | moe | none


# ----------------------------------------------------------------------
# Shapes (assigned input-shape set, identical for all LM archs)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "stablelm_12b",
    "deepseek_7b",
    "gemma3_1b",
    "internlm2_20b",
    "jamba_v01_52b",
    "whisper_medium",
    "deepseek_moe_16b",
    "granite_moe_1b",
    "mamba2_130m",
    "llava_next_mistral_7b",
]

# archs for which long_500k runs (sub-quadratic / mostly-local attention);
# the rest skip it (pure full attention — see DESIGN.md §Arch-applicability)
LONG_CTX_ARCHS = {"mamba2_130m", "jamba_v01_52b", "gemma3_1b"}


def get(name: str):
    """Return the module for arch ``name`` (exposes CONFIG and SMOKE)."""
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod


def get_config(name: str) -> ModelConfig:
    return get(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return get(name).SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, with skip annotations."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and arch not in LONG_CTX_ARCHS:
                skip = "pure full-attention arch: 500k dense-KV decode exempted"
            if skip is None or include_skipped:
                out.append((arch, shape.name, skip))
    return out
