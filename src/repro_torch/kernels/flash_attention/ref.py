"""Plain PyTorch version: causal (optionally sliding-window) GQA attention."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd); H % KV == 0 -> out (B,H,Sq,hd)."""
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qf = q.reshape(B, KV, G, Sq, hd).float()
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bcgqh,bckh->bcgqk", qf, kf) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        s = s.masked_fill(~m, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcgqk,bckh->bcgqh", p, vf)
    return out.reshape(B, H, Sq, hd).to(q.dtype)
