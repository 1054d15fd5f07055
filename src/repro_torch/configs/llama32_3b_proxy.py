"""llama3.2-3b — the paper's cascade *proxy* model (Lotus/BARGAIN baselines)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b-proxy",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    rope_theta=5e5,
    source="[hf:meta-llama/Llama-3.2-3B; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512,
    dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
