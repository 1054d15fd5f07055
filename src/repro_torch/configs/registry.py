"""Central registry of the per-arch config modules ported so far."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = [
    "qwen15_05b",
    # the paper's oracle LLM
    "llama31_8b",
    # dense with 5:1 sliding-window:global layers (the decode ring buffer)
    "gemma3_12b",
    # the paper's embedding encoder (repro_torch.embeddings.encoder)
    "e5_encoder",
]

ARCHS: Dict[str, "object"] = {}
for m in _ARCH_MODULES:
    mod = importlib.import_module(f"repro_torch.configs.{m}")
    ARCHS[mod.CONFIG.name] = mod


def list_archs():
    return list(ARCHS.keys())


def get_config(name: str) -> ModelConfig:
    return ARCHS[name].CONFIG


def smoke_config(name: str) -> ModelConfig:
    return ARCHS[name].SMOKE
