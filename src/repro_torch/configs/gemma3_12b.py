"""gemma3-12b [dense] — 5:1 local(1024):global attention, 262k vocab
[hf:google/gemma-3-1b-pt; unverified].  head_dim=256 explicit (≠ d/H)."""
from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024, ffn="dense")
_GLOBAL = LayerSpec(kind="attn", window=None, ffn="dense")

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope_theta=1e6,
    source="[hf:google/gemma-3-1b-pt; unverified]",
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, dtype="float32", attn_chunk_q=16, attn_chunk_kv=16,
    pattern=(LayerSpec(kind="attn", window=16, ffn="dense"),) * 5 + (_GLOBAL,),
)
