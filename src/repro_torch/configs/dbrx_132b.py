"""dbrx-132b [moe] — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    pattern=(LayerSpec(kind="attn", ffn="moe"),),
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
    moe_chunk=1024,
    source="[hf:databricks/dbrx-base; unverified]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512,
    n_experts=4, top_k=2, dtype="float32", moe_chunk=0,
    attn_chunk_q=16, attn_chunk_kv=16,
)
