"""Config registry: repro_torch.configs.get("<arch-id>") → ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_CELLS, ModelConfig, ShapeCell  # noqa: F401

ARCHS = (
    "mixtral-8x22b",
    "llama4-maverick-400b-a17b",
    "stablelm-12b",
    "qwen3-14b",
    "llama3-8b",
    "yi-34b",
    "rwkv6-1.6b",
    "llava-next-34b",
    "zamba2-7b",
    "whisper-small",
)


def get(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module("repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
