"""ctypes wrapper of the hand-written flash-attention prefill kernel (K4).

The CUDA source is ``repro_torch/csrc/flash_attention.cu``; it replaces the
Pallas kernel ``flash_attention_pallas``
(src/repro/kernels/flash_attention/kernel.py:70).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd) on the card -> (B,H,Sq,hd)."""
    build.require_cuda("flash_attention_cuda", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, hd = q.shape
    _, KV, Sk, hdk = k.shape
    if hd not in HEAD_DIMS or hdk != hd or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != B or KV == 0 or H % KV:
        raise ValueError(f"flash_attention_cuda shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty_like(q)
    if B * Sq == 0:
        return out
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, hd, int(causal), 0 if window is None else int(window),
        DTYPE_CODES[q.dtype], build.stream_ptr(q.device))
    build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
