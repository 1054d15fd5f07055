"""Central registry of the per-arch config modules (the reference's, in
its order)."""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig, ShapeCell

_ARCH_MODULES = [
    "falcon_mamba_7b",
    "mixtral_8x22b",
    "dbrx_132b",
    "internvl2_26b",
    "gemma3_12b",
    "stablelm_12b",
    "codeqwen15_7b",
    "qwen15_05b",
    "jamba_v01_52b",
    "whisper_base",
    # the paper's own backbones (oracle LLM + proxy + embedder)
    "llama31_8b",
    "llama32_3b_proxy",
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


# ---------------------------------------------------------------------------
# long-context applicability
# ---------------------------------------------------------------------------

LONG_CONTEXT_OK = {
    "falcon-mamba-7b": "O(1) SSM state",
    "jamba-v0.1-52b": "hybrid: 4/32 attention layers, rest O(1) Mamba state",
    "mixtral-8x22b": "SWA: ring KV bounded by window=4096",
    "gemma3-12b": "5:1 local(1024-ring):global; 8 global layers keep full KV "
                  "(sharded); beyond its 128k design point — boundary case",
}

_LONG_SKIP = {
    "dbrx-132b": "pure full attention: unbounded 500k KV on all 40 layers",
    "internvl2-26b": "pure full attention on all 48 layers",
    "stablelm-12b": "pure full attention on all 40 layers",
    "codeqwen1.5-7b": "pure full attention (MHA kv=32) on all 32 layers",
    "qwen1.5-0.5b": "pure full attention (MHA kv=16) on all 24 layers",
    "whisper-base": "enc-dec with 448-token decoder design limit",
}


def long_context_skip_reason(name: str):
    return _LONG_SKIP.get(name)


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def input_logical_axes(batch: dict) -> dict:
    """Logical axes of a step's inputs, as the reference's dry run places
    them: tokens and targets on "batch", the modality stubs on "batch",
    decode positions on "kv_batch"; a decode cache is placed by
    ``lm.cache_logical_axes`` and has no entry here."""
    def one(name, leaf):
        if name in ("tokens", "targets"):
            return ("batch",) + (None,) * (leaf.ndim - 1)
        if name in ("prefix_embeds", "enc_frames"):
            return ("batch", None, None)
        if name == "pos":
            return ("kv_batch",)
        return (None,) * leaf.ndim
    return {k: one(k, v) for k, v in batch.items() if k != "cache"}


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Meta inputs for the step function selected by shape.kind.

    train/prefill: token batch (+ modality stubs).  decode: one new token
    per sequence + a meta KV cache covering shape.seq_len (the port's
    cache layout: one dict per superblock).
    """
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    dt = getattr(torch, cfg.dtype)

    if shape.kind in ("train", "prefill"):
        P = cfg.num_prefix_embeds
        spec = {"tokens": meta((B, S - P), torch.int32)}
        if shape.kind == "train":
            spec["targets"] = meta((B, S - P), torch.int32)
        if P:
            spec["prefix_embeds"] = meta((B, P, cfg.d_model), dt)
        if cfg.is_encdec:
            spec["enc_frames"] = meta((B, cfg.encoder_len, cfg.d_model), dt)
        return spec

    # decode: 1 new token against a cache of S
    from repro_torch.models import lm
    return {
        "tokens": meta((B,), torch.int32),
        "pos": meta((B,), torch.int32),
        "cache": lm.make_cache(cfg, B, S, device="meta"),
    }
