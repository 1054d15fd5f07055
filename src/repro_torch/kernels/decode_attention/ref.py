"""Plain PyTorch version: single-token decode attention over a KV cache."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths):
    """q (B,H,hd); k/v (B,KV,L,hd); lengths (B,) valid prefix -> (B,H,hd)."""
    B, H, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bcgh,bclh->bcgl", qf, k.float()) / math.sqrt(hd)
    valid = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcgl,bclh->bcgh", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
