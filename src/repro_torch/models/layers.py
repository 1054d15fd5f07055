"""Model layers, dense subset: norms, RoPE, attention (GQA/SWA), MLP.

Conventions (the reference's)
-----------------------------
- activations ``(B, S, D)``; q ``(B, S, KV, G, hd)``; k/v ``(B, S, KV, hd)``;
  query head h = kv * G + g reads KV head h // G.
- GQA is computed with grouped einsums (no KV head repetition in memory).
- softmax runs in float32 regardless of the parameter type.
- params are plain nested dicts of tensors.

Chunked attention, MoE and Mamba are later slices of the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p, x):
    xf = x.float()
    if cfg.norm_type == "ln":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, n, hd); positions: broadcastable to (..., S).

    Rotate-half RoPE: the first and second halves of hd are the pair.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _project_qkv(cfg, p, x, kv_x=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, KV, H // KV, hd),
            k.reshape(B, Skv, KV, hd),
            v.reshape(B, Skv, KV, hd))


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask broadcastable (B,1,1,Sq,Sk)."""
    scores = torch.einsum("bqcgh,bkch->bcgqk", q.float(), k.float())
    scores = scores * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bcgqk,bkch->bqcgh", probs.to(v.dtype), v)


def _causal_window_mask(q_pos, k_pos, window):
    """(..., Sq, Sk) bool mask: causal, optionally within sliding window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _positions(S: int, device):
    return torch.arange(S, device=device)[None, :]


def attention_plain(cfg: ModelConfig, p, x, *, causal: bool, window=None,
                    positions=None, kv_x=None, rope: bool = True):
    """Full-matrix attention; fine for short sequences / encoders."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if positions is None:
        positions = _positions(S, x.device)
    if rope and cfg.pos_type == "rope" and kv_x is None:
        q = apply_rope(q.reshape(B, S, -1, hd), positions,
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if causal:
        kpos = torch.arange(k.shape[1], device=x.device)[None, :]
        mask = _causal_window_mask(positions, kpos, window)[:, None, None]
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, S, -1)
    return out @ p["wo"]


def attention_flash(cfg: ModelConfig, p, x, *, causal=True, window=None,
                    positions=None):
    """The flash-attention kernel on the prefill/forward hot path.

    ``attn_impl="flash"`` runs ``repro_torch.kernels.flash_attention`` (the
    CUDA kernel on the card, its plain version on the CPU);
    ``attn_impl="flash-ref"`` runs the plain version everywhere.  Mask
    positions are sequence-local 0..S-1; ``positions`` feeds RoPE only.
    """
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = _positions(S, x.device)
    if cfg.pos_type == "rope":
        q = apply_rope(q.reshape(B, S, -1, hd), positions,
                       cfg.rope_theta).reshape(q.shape)
        k = apply_rope(k, positions, cfg.rope_theta)
    qh = q.reshape(B, S, -1, hd).transpose(1, 2).contiguous()  # (B,H,S,hd)
    kh = k.transpose(1, 2).contiguous()                         # (B,KV,S,hd)
    vh = v.transpose(1, 2).contiguous()
    impl = "ref" if cfg.attn_impl == "flash-ref" else "auto"
    out = flash_attention(qh, kh, vh, causal=causal, window=window,
                          impl=impl)
    out = out.transpose(1, 2).reshape(B, S, -1)                 # (B,S,H*hd)
    return out @ p["wo"]


def attention_apply(cfg: ModelConfig, p, x, *, causal=True, window=None,
                    positions=None, kv_x=None):
    """Dispatch plain vs flash by config / seq length (reference routing)."""
    S = x.shape[1]
    impl = cfg.attn_impl
    if kv_x is not None or not causal:
        return attention_plain(cfg, p, x, causal=causal, window=window,
                               positions=positions, kv_x=kv_x)
    if impl in ("flash", "flash-ref"):
        if S % min(128, S) == 0:  # the reference kernel's block divisibility
            return attention_flash(cfg, p, x, causal=causal, window=window,
                                   positions=positions)
        return attention_plain(cfg, p, x, causal=causal, window=window,
                               positions=positions)
    if impl == "plain" or (impl == "auto" and S <= 4096 and window is None):
        return attention_plain(cfg, p, x, causal=causal, window=window,
                               positions=positions)
    if S % min(cfg.attn_chunk_q, S) != 0:
        return attention_plain(cfg, p, x, causal=causal, window=window,
                               positions=positions)
    raise NotImplementedError(
        f"attn_impl={impl!r} at S={S} takes the chunked attention schedules, "
        "which are not ported yet (ROADMAP.md queue 1: the model zoo)")


# --------------------------------------------------------------------------
# MLP (dense)
# --------------------------------------------------------------------------


def apply_mlp(cfg: ModelConfig, p, x):
    if cfg.mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu((x @ p["w_in"] + p["b_in"]).float(),
                   approximate="tanh").to(x.dtype)
        return h @ p["w_out"] + p["b_out"]
    g = F.silu((x @ p["w_gate"]).float()).to(x.dtype)
    return (g * (x @ p["w_up"])) @ p["w_down"]
