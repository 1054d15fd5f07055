"""ctypes wrapper of the hand-written flash-attention prefill kernel (K4).

The CUDA source is ``repro_torch/csrc/flash_attention.cu``; it replaces the
Pallas kernel ``flash_attention_pallas``
(src/repro/kernels/flash_attention/kernel.py:70).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd) on the card -> (B,H,Sq,hd).

    q, k and v may be strided views (the model's (B,S,H,hd) projections
    transposed) as long as hd has stride 1.  The output is a (B,H,Sq,hd)
    view of a (B,Sq,H,hd) tensor, so ``out.transpose(1, 2).reshape(B, Sq,
    -1)`` costs no copy.
    """
    name = "flash_attention_cuda"
    build.refuse_dtensor(name, q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, H, Sq, hd = q.shape
    _, KV, Sk, hdk = k.shape
    if hd not in HEAD_DIMS or hdk != hd or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != B or KV == 0 or H % KV:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: hd must be at stride 1, got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    build.require_cuda(name, q, k, v, contiguous=False)
    build.refuse_grad(name, q, k, v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * Sq == 0:
        return out
    if q.dtype == torch.bfloat16:  # the tensor-core path copies 16 bytes
        build.require_vector_access(name, q, k, v)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, hd, int(causal), 0 if window is None else int(window),
        DTYPE_CODES[q.dtype], strides, build.stream_ptr(q.device))
    build.check(err, "flash_attention_fwd")
    build.count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
