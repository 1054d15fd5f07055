"""internvl2-26b [vlm] — InternViT (stub) + InternLM2 backbone [arXiv:2404.16821; hf].

The vision frontend is a STUB: the caller supplies 256 precomputed patch
embeddings as ``prefix_embeds``, prepended to the text tokens; a declared
seq_len counts the combined sequence.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,  # padded to 92672 for TP divisibility
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    num_prefix_embeds=256,
    source="[arXiv:2404.16821; hf]",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    num_prefix_embeds=4, dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
)
