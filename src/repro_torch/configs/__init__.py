"""Config registry: get_config("<arch-id>") for every assigned architecture.

`ARCH_IDS` is the port's own copy of `repro.configs`: the same ten configs,
field for field (the port's fields that the reference lacks at their
defaults), every one served and trained by the port. `PORT_ARCH_IDS` are
configs of the port alone, which the reference cannot build;
`ALL_ARCH_IDS` is both.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_skips

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "qwen2-moe-a2.7b",
    "whisper-base",
    "mistral-large-123b",
    "deepseek-67b",
    "glm4-9b",
    "granite-20b",
    "zamba2-1.2b",
    "chameleon-34b",
    "rwkv6-1.6b",
]
PORT_ARCH_IDS = ["moonlight-16b-a3b"]
ALL_ARCH_IDS = ARCH_IDS + PORT_ARCH_IDS

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "whisper-base": "whisper_base",
    "mistral-large-123b": "mistral_large_123b",
    "deepseek-67b": "deepseek_67b",
    "glm4-9b": "glm4_9b",
    "granite-20b": "granite_20b",
    "zamba2-1.2b": "zamba2_1_2b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "ALL_ARCH_IDS", "get_config", "get_shape", "SHAPES", "shape_skips", "ArchConfig"]
