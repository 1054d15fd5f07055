"""Model configuration system (the reference's, field for field).

Every architecture is expressed as a ``ModelConfig``: a repeating
*superblock* pattern of heterogeneous layers (attention / Mamba,
dense-FFN / MoE / no-FFN) repeated ``n_layers/len(pattern)`` times.  The
port runs the superblocks as a Python loop over layers; fields that only
steer the reference's XLA programs (remat, scan, chunk sizes) are kept so
that a config means the same in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 128


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a superblock."""

    kind: str = "attn"  # "attn" | "mamba"
    window: Optional[int] = None  # sliding-window size; None = global attention
    ffn: str = "dense"  # "dense" | "moe" | "none"

    def __post_init__(self):
        assert self.kind in ("attn", "mamba"), self.kind
        assert self.ffn in ("dense", "moe", "none"), self.ffn


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # ssm | moe | vlm | dense | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-1) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0  # 0 = decoder-only
    encoder_len: int = 0  # stub modality frontend sequence length
    # --- VLM prefix stub (internvl2) ---
    num_prefix_embeds: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    norm_type: str = "rms"  # "rms" | "ln"
    pos_type: str = "rope"  # "rope" | "sinusoidal"
    mlp_type: str = "swiglu"  # "swiglu" | "gelu"
    moe_chunk: int = 8192  # token-chunk for MoE dispatch (0 = off)
    # implementation switches (perf levers; see EXPERIMENTS.md §Perf)
    # "plain" | "chunked" | "auto" | "tri" | "flash" (the CUDA kernels on
    # the card, their plain versions on the CPU) | "flash-ref" (the plain
    # versions everywhere)
    attn_impl: str = "auto"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    swa_banded: bool = True  # skip KV chunks fully outside a sliding window
    ssm_chunk: int = 256
    remat_policy: str = "full"  # "full" | "dots" | "none"
    remat_inner: bool = True  # remat inside chunk scans (mamba/moe/attn)
    loss_chunk: int = 1024  # CE loss sequence-chunking (0 = off)
    scan_layers: bool = True
    source: str = ""  # provenance note ([arXiv/hf; tier])

    # ---------------------------------------------------------------- helpers
    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"superblock size {len(self.pattern)}"
        )
        if any(s.ffn == "moe" for s in self.pattern):
            assert self.n_experts > 0 and self.top_k > 0, self.name

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        v = self.vocab_size
        m = VOCAB_PAD_MULTIPLE
        return (v + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return (self.d_model + 15) // 16

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_specs(self):
        """Full per-layer spec list (pattern repeated)."""
        return list(self.pattern) * self.n_superblocks

    # ------------------------------------------------------------- accounting
    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for roofline)."""
        D, V = self.d_model, self.padded_vocab
        hd, H, KV = self.resolved_head_dim, self.n_heads, self.n_kv_heads
        n = V * D  # embedding (tied head)
        if not self.tie_embeddings:
            n += V * D
        for spec in self.layer_specs():
            n += D  # pre-norm
            if spec.kind == "attn":
                n += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
                if self.qkv_bias:
                    n += H * hd + 2 * KV * hd
            else:  # mamba
                di, ds, dr = self.d_inner, self.ssm_state, self.dt_rank
                n += D * 2 * di + self.ssm_conv * di + di  # in_proj, conv
                n += di * (dr + 2 * ds) + dr * di + di  # x_proj, dt_proj(+bias)
                n += di * ds + di  # A_log, D
                n += di * D  # out_proj
            if spec.ffn == "dense":
                n += D + 3 * D * self.d_ff  # norm + swiglu
            elif spec.ffn == "moe":
                n += D + D * self.n_experts  # norm + router
                n += self.n_experts * 3 * D * self.d_ff
        n += D  # final norm
        if self.is_encdec:
            # encoder layers: attn + dense ffn + norms; cross-attn in decoder
            enc = self.encoder_layers * (
                2 * D + D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D + 3 * D * self.d_ff
            )
            # decoder cross-attention blocks (one per decoder layer)
            xattn = self.n_layers * (D + D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D)
            n += enc + xattn + D  # + encoder final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        full_moe = moe_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active_moe = moe_layers * self.top_k * 3 * self.d_model * self.d_ff
        return self.param_count() - full_moe + active_moe

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def uniform_pattern(kind="attn", window=None, ffn="dense") -> Tuple[LayerSpec, ...]:
    return (LayerSpec(kind=kind, window=window, ffn=ffn),)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
