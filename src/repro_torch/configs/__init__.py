"""Architecture configs: one module per assigned arch + shape definitions."""
from .base import (
    ARCH_IDS,
    LONG_CTX_ARCHS,
    SHAPES,
    EncDecConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    VLMConfig,
    cells,
    get,
    get_config,
    get_smoke,
)

__all__ = [
    "ARCH_IDS",
    "LONG_CTX_ARCHS",
    "SHAPES",
    "EncDecConfig",
    "LayerSpec",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "VLMConfig",
    "cells",
    "get",
    "get_config",
    "get_smoke",
]
