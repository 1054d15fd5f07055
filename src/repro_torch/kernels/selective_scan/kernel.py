"""ctypes wrapper of the hand-written selective-scan kernel (K6).

The CUDA source is ``repro_torch/csrc/selective_scan.cu``.  It replaces
no Pallas kernel: the reference's ``mamba_scan`` is a
``lax.associative_scan`` (src/repro/models/layers.py:587).  The port adds
it because Mamba's prefill scan in plain torch wrote (B, S, d_inner, 16)
float32 tensors several times over; the kernel keeps each channel's state
in registers and reads its inputs once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
D_STATE = 16  # the kernel's state size, the only one the port's configs use


def selective_scan_cuda(x, dt, B, C, z, A, D, h0=None):
    """x, z (Bt,S,di) float32 or bfloat16; dt (Bt,S,di), B, C (Bt,S,16),
    A (di,16), D (di,), h0 (Bt,di,16) float32, on the card -> (y
    (Bt,S,di) in x's dtype, h_last (Bt,di,16) float32).

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from h0 (zeros when None),
    y_t = (C_t . h_t + D x_t) silu(z_t), all in float32.  B and C may be
    views with the state at stride 1 (the gates' split of one product).
    """
    name = "selective_scan_cuda"
    tensors = [x, dt, B, C, z, A, D] + ([] if h0 is None else [h0])
    build.refuse_dtensor(name, *tensors)
    Bt, S, di = x.shape
    if A.shape[-1] != D_STATE:
        raise ValueError(f"{name} takes d_state {D_STATE}, got "
                         f"{A.shape[-1]}")
    if tuple(z.shape) != tuple(x.shape) or tuple(dt.shape) != (Bt, S, di) \
            or tuple(B.shape) != (Bt, S, D_STATE) \
            or tuple(C.shape) != (Bt, S, D_STATE) \
            or tuple(A.shape) != (di, D_STATE) or tuple(D.shape) != (di,) \
            or (h0 is not None and tuple(h0.shape) != (Bt, di, D_STATE)):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, z {tuple(z.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}")
    build.require_cuda(name, *tensors, contiguous=False)
    build.refuse_grad(name, *tensors, instead="call it under "
                      "torch.no_grad(); the model differentiates through "
                      "its chunked recurrence")
    if x.dtype not in DTYPE_CODES or z.dtype != x.dtype or any(
            t.dtype != torch.float32 for t in tensors[1:4] + tensors[5:]):
        raise TypeError(f"{name} takes x and z in float32 or bfloat16 and "
                        f"the rest in float32, got x {x.dtype}, z {z.dtype}")
    x, dt, z, D = (t.contiguous() for t in (x, dt, z, D))
    if B.stride() != C.stride() or B.stride(-1) != 1:
        B, C = B.contiguous(), C.contiguous()
    # the kernel reads a channel's 16 values of A and h0 as 16-byte loads
    A, h0 = (t if t is None or build.vector_rows(t) and t.is_contiguous()
             else t.contiguous().clone() for t in (A, h0))
    y = torch.empty_like(x)
    h_last = torch.empty((Bt, di, D_STATE), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:  # nothing to scan: the state stays as given
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    err = build.library().selective_scan_fwd(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        z.data_ptr(), A.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), Bt, S, di, B.stride(0), B.stride(1),
        DTYPE_CODES[x.dtype], build.stream_ptr(x.device))
    build.check(err, "selective_scan_fwd")
    build.count_launch(selective_scan_cuda)
    return y, h_last


selective_scan_cuda.launches = 0
