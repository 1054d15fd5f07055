"""stablelm-12b [dense] — GQA kv=8 [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    source="[hf:stabilityai/stablelm-2-1_6b; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
