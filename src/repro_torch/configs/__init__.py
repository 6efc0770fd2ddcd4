"""Workloads the port runs: the paper's Harris case study
(``configs/harris.py``) and the architecture registry — ``--arch <id>``
resolution, a copy of the JAX package's ``configs/__init__.py``."""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ArchConfig, ShapeConfig, supports_shape

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-12b": "gemma3_12b",
    "gemma3-27b": "gemma3_27b",
    "deepseek-67b": "deepseek_67b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.config


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "get_config",
           "all_configs", "supports_shape"]
