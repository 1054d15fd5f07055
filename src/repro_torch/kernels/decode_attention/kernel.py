"""ctypes wrapper of the hand-written flash-decoding kernel (K5).

The CUDA source is ``repro_torch/csrc/decode_attention.cu``; it replaces
the Pallas kernel ``decode_attention_pallas``
(src/repro/kernels/decode_attention/kernel.py:62).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def decode_attention_cuda(q, k, v, lengths):
    """q (B,H,hd); k/v (B,KV,L,hd); lengths (B,) on the card -> (B,H,hd).

    k and v may be strided views (the model's (B,L,KV,hd) cache permuted)
    as long as they share strides, hd has stride 1 and each row starts on
    16 bytes; q is made contiguous.
    """
    name = "decode_attention_cuda"
    build.refuse_dtensor(name, q, k, v, lengths)
    build.require_cuda(name, q, k, v, lengths, contiguous=False)
    build.refuse_grad(name, q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, H, hd = q.shape
    _, KV, L, hdk = k.shape
    if hd not in HEAD_DIMS or hdk != hd or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != B or KV == 0 or H % KV or L == 0 \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError(f"{name}: k and v must share strides with hd at "
                         f"stride 1, got {k.stride()} and {v.stride()}")
    build.require_vector_access(name, k, v)  # 16-byte loads of K/V rows
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    sb, sc, sl, _ = k.stride()
    err = build.library().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, KV, L, hd, sb, sc, sl, DTYPE_CODES[q.dtype],
        build.stream_ptr(q.device))
    build.check(err, "decode_attention_fwd")
    build.count_launch(decode_attention_cuda)
    return out


decode_attention_cuda.launches = 0
