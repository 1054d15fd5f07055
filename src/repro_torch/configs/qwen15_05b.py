"""qwen1.5-0.5b [dense] — QKV bias, MHA kv=16 [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    qkv_bias=True,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
