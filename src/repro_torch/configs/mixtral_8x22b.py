"""mixtral-8x22b [moe] — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec(kind="attn", window=4096, ffn="moe"),),
    n_experts=8,
    top_k=2,
    rope_theta=1e6,
    moe_chunk=1024,
    source="[arXiv:2401.04088; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    n_experts=4, top_k=2, dtype="float32", moe_chunk=0,
    pattern=(LayerSpec(kind="attn", window=16, ffn="moe"),),
    attn_chunk_q=16, attn_chunk_kv=16,
)
