"""e5-large-style embedding encoder — the paper's default embedding model
[arXiv:2212.03533].  Used bidirectionally with mean pooling (see
repro_torch.embeddings.encoder)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="e5-large",
    family="encoder",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30592,  # bert-style vocab, padded
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    norm_type="ln",
    pos_type="sinusoidal",
    mlp_type="gelu",
    source="[arXiv:2212.03533; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    dtype="float32",
)
