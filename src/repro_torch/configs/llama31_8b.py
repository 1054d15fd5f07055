"""llama3.1-8b — the paper's oracle LLM backbone [arXiv:2302.13971 lineage; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    rope_theta=5e5,
    source="[hf:meta-llama/Llama-3.1-8B; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
