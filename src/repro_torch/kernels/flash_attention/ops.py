"""Dispatcher: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  A CUDA tensor never reaches the plain version unless the caller
asks for it with ``impl="ref"`` (``attn_impl="flash-ref"``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    impl: str = "auto"):
    """``impl``: "auto" (kernel on CUDA, plain on CPU) or "ref" (plain)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; expected 'auto' or 'ref'")
    if impl == "ref" or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
