"""falcon-mamba-7b [ssm] — attention-free Mamba-1 LM [arXiv:2410.05355; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=32,  # unused (attention-free); kept for interface uniformity
    n_kv_heads=8,
    d_ff=0,
    vocab_size=65024,
    pattern=(LayerSpec(kind="mamba", ffn="none"),),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="[arXiv:2410.05355; unverified]",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, vocab_size=512,
    dtype="float32", ssm_chunk=16,
)
