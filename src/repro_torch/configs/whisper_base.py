"""whisper-base [audio] — enc-dec; conv frontend STUB [arXiv:2212.04356; unverified].

The caller supplies 1500 precomputed frame embeddings (post-conv stem) as
``enc_frames``; decoder sequence length follows the declared shape.  LayerNorm + sinusoidal
positions + GELU MLP per the original architecture.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    encoder_layers=6,
    encoder_len=1500,
    norm_type="ln",
    pos_type="sinusoidal",
    mlp_type="gelu",
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = CONFIG.replace(
    n_layers=2, encoder_layers=2, encoder_len=12, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, dtype="float32",
    attn_chunk_q=16, attn_chunk_kv=16,
)
