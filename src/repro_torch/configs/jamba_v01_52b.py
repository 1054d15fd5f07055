"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Period-8 superblock: attention at index 4, Mamba elsewhere; MoE FFN on odd
indices, dense FFN on even (Jamba applies MoE every other layer).
"""
from repro_torch.models.config import LayerSpec, ModelConfig


def _layer(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(kind=kind, ffn=ffn)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(_layer(i) for i in range(8)),
    n_experts=16,
    top_k=2,
    ssm_state=16,
    moe_chunk=1024,
    source="[arXiv:2403.19887; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    n_experts=4, top_k=2, dtype="float32", moe_chunk=0, ssm_chunk=16,
    attn_chunk_q=16, attn_chunk_kv=16,
)
