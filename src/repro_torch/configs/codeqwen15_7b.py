"""codeqwen1.5-7b [dense] — qwen1.5 arch, QKV bias, MHA kv=32 [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    qkv_bias=True,
    rope_theta=1e6,
    source="[hf:Qwen/CodeQwen1.5-7B; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
