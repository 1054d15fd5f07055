"""Model layers: norms, RoPE, attention (GQA/SWA, prefill and decode,
cross-attention), MLP, MoE, Mamba.

Conventions (the reference's)
-----------------------------
- activations ``(B, S, D)``; q ``(B, S, KV, G, hd)``; k/v ``(B, S, KV, hd)``;
  query head h = kv * G + g reads KV head h // G.
- GQA is computed with grouped einsums (no KV head repetition in memory).
- softmax, the MoE router and the SSM scan run in float32 regardless of
  the parameter type.
- params are plain nested dicts of tensors.

``attention_chunked`` holds the reference's three chunked schedules
(banded sliding window, the ``tri`` triangle-packed causal schedule and
the masked rectangle) as loops over q/kv chunks with an online softmax in
float32.  ``attention_decode`` is the decode step's attention: global
layers on the flash-decoding kernel (``attn_impl="flash"``),
sliding-window ring buffers and cross-attention in plain torch.  MoE
(token-choice top-k with capacity-bounded per-sequence dispatch) is plain
torch, as the reference's is plain ``jnp``.  Mamba-1's prefill scan runs
on the hand-written selective-scan kernel (K6) where it can (a CUDA
tensor, no autograd, no mesh), and on its plain chunked recurrence
elsewhere; the rest of Mamba (projections, conv, gates, the decode step)
is plain torch.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import partition
from repro_torch.distributed.api import merge_heads, shard_act, split_dim
from repro_torch.distributed.partition import by_rule
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch.op_cost import replayed
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import get_tracer

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


def sinusoidal_positions(positions, d_model: int):
    """Whisper-style sinusoidal embeddings; positions (..., S) -> (..., S, D)
    float32."""
    half = d_model // 2
    freqs = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        * (math.log(10000.0) / max(1, half - 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _project_qkv(cfg, p, x, kv_x=None):
    """q (B, S, H, hd), its H = KV * G heads flat, and k/v (B, Skv, KV,
    hd).  q is grouped by its KV heads only inside the attention
    products, so a DTensor q keeps its split over a mesh axis that
    divides the H heads where the KV heads do not divide it
    (``partition.sdpa``)."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv_x = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_dim(q, -1, (cfg.n_heads, hd)),
            split_dim(k, -1, (KV, hd)),
            split_dim(v, -1, (KV, hd)))


@by_rule(partition.sdpa)
def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable (B,1,1,Sq,Sk)
    -> (B,Sq,H,hd); query head h = kv * G + g reads KV head kv."""
    q = q.unflatten(2, (k.shape[2], -1))
    scores = torch.einsum("bqcgh,bkch->bcgqk", q.float(), k.float())
    scores = scores * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bcgqk,bkch->bqcgh", probs.to(v.dtype),
                        v).flatten(2, 3)


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
    S = x.shape[1]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if positions is None:
        positions = _positions(S, x.device)
    if rope and cfg.pos_type == "rope" and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if causal:
        kpos = torch.arange(k.shape[1], device=x.device)[None, :]
        mask = _causal_window_mask(positions, kpos, window)[:, None, None]
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    return merge_heads(out, p["wo"]) @ p["wo"]


def attention_chunked(cfg: ModelConfig, p, x, *, causal: bool, window=None,
                      positions=None):
    """Flash-style chunked attention in plain torch (online softmax).

    Three schedules, as the reference's:
      - window (banded, ``cfg.swa_banded``): q-chunk i attends only the kv
        chunks of its band, the diagonal chunk first;
      - causal + ``attn_impl == "tri"``: triangle-packed — the (qi, kj)
        lower-triangle block pairs only, row-major;
      - otherwise: the rectangle, every kv chunk of every q chunk, masked.
    The running max, sum and output of each q chunk stay in float32
    whatever the model type, so a bf16 model adds up as the reference's
    scan does.  Mask positions are sequence-local (the q rows of the
    banded schedule take ``positions`` when it has one row per batch row,
    as the reference's); ``positions`` feeds RoPE.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cq = min(cfg.attn_chunk_q, S)
    ck = min(cfg.attn_chunk_kv, S)
    if S % cq or S % ck:
        raise ValueError(f"attention_chunked: S={S} is not a multiple of "
                         f"the chunks ({cq}, {ck})")

    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = _positions(S, x.device)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    banded = window is not None and cfg.swa_banded
    schedule = ("banded" if banded else
                "tri" if causal and cfg.attn_impl == "tri" else "rect")
    rows = positions if banded and positions.shape[0] == B else None
    out = _chunked_sdpa(q, k, v, rows, 1.0 / math.sqrt(hd), causal=causal,
                        window=window, cq=cq, ck=ck, schedule=schedule)
    return merge_heads(out, p["wo"]) @ p["wo"]


@by_rule(partial(partition.sdpa, split_rows=False))
def _chunked_sdpa(q, k, v, rows, scale, *, causal, window, cq, ck,
                  schedule):
    """``attention_chunked``'s loops over q/kv chunks: q (B,S,H,hd), k/v
    (B,S,KV,hd) -> (B,S,H,hd).  ``rows`` (B, S), where given, are the
    banded schedule's q positions; else chunk qi's rows are qi * cq ..
    (qi + 1) * cq - 1."""
    B, S, KV, hd = k.shape
    q = q.unflatten(2, (KV, -1))
    G = q.shape[3]
    nq, nk = S // cq, S // ck
    dev = q.device

    if schedule == "banded":
        # banded: only the last wb+1 kv chunks can intersect the window
        wb = -(-window // ck)  # ceil
        nband = min(nk, wb + -(-cq // ck))

        def kv_chunks(qi):
            base = (qi * cq) // ck
            # kv chunk base - off; the reference clamps negative chunks to
            # 0 and discards their update, so they are skipped here
            return [base - off for off in range(nband) if base - off >= 0]
    elif schedule == "tri":
        def kv_chunks(qi):
            hi = ((qi + 1) * cq + ck - 1) // ck  # kv chunks covering <= q end
            return range(min(hi, nk))
    else:
        def kv_chunks(qi):
            return range(nk)

    outs = []
    for qi in range(nq):
        span = slice(qi * cq, (qi + 1) * cq)
        q_blk = q[:, span]
        if rows is not None:
            qi_pos = rows[:, span]
        else:
            qi_pos = torch.arange(cq, device=dev)[None] + qi * cq
        m = torch.full((B, KV, G, cq), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, cq, hd), dtype=torch.float32,
                          device=dev)
        for kj in kv_chunks(qi):
            m, l, acc = _online_block(q_blk, k, v, qi_pos, m, l, acc, kj, ck,
                                      scale, causal, window)
        o = acc / torch.clamp(l[..., None], min=1e-30)    # (B,KV,G,cq,hd)
        outs.append(o.permute(0, 3, 1, 2, 4).to(v.dtype))
    return torch.cat(outs, dim=1).flatten(2, 3)


@replayed(7)
def _online_block(q_blk, k, v, qi_pos, m, l, acc, kj, ck, scale, causal,
                  window):
    """Online-softmax update of one q chunk's running max ``m``, sum
    ``l`` and output ``acc`` by kv chunk ``kj`` (keys kj * ck .. (kj + 1)
    * ck - 1).  Its counts do not depend on ``kj``: the dry run replays
    them (``launch.op_cost.replayed``)."""
    k_blk = k[:, kj * ck:(kj + 1) * ck]
    v_blk = v[:, kj * ck:(kj + 1) * ck]
    s = torch.einsum("bqcgh,bkch->bcgqk", q_blk.float(),
                     k_blk.float()) * scale
    if causal:
        kj_pos = torch.arange(ck, device=k.device)[None] + kj * ck
        msk = _causal_window_mask(qi_pos, kj_pos, window)[:, None, None]
        s = s.masked_fill(~msk, -1e30)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p_ = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p_, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bcgqk,bkch->bcgqh", p_.to(v.dtype), v_blk).float()
    return m_new, l_new, acc_new


def attention_flash(cfg: ModelConfig, p, x, *, causal=True, window=None,
                    positions=None):
    """The flash-attention kernel on the prefill/forward hot path.

    ``attn_impl="flash"`` runs ``repro_torch.kernels.flash_attention`` (the
    CUDA kernel on the card, its plain version on the CPU);
    ``attn_impl="flash-ref"`` runs the plain version everywhere.  Mask
    positions are sequence-local 0..S-1; ``positions`` feeds RoPE only.

    The kernel has no backward, as the reference's Pallas kernel has no
    JVP rule, so ``attn_impl="flash"`` raises on both devices where
    autograd would differentiate it; ``"flash-ref"`` trains.
    """
    from repro_torch.kernels.build import refuse_grad
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x)
    if cfg.attn_impl == "flash":
        refuse_grad('attn_impl="flash"', q, k, v)
    if positions is None:
        positions = _positions(S, x.device)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # (B,H,S,hd) and (B,KV,S,hd) views of the (B,S,heads,hd) projections:
    # the kernel takes their strides, and its output lies as (B,S,H,hd),
    # so neither side copies
    qh = q.transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    impl = "ref" if cfg.attn_impl == "flash-ref" else "auto"
    out = flash_attention(qh, kh, vh, causal=causal, window=window,
                          impl=impl)
    out = out.transpose(1, 2).reshape(B, S, -1)                 # (B,S,H*hd)
    return out @ p["wo"]


def attention_apply(cfg: ModelConfig, p, x, *, causal=True, window=None,
                    positions=None, kv_x=None):
    """Dispatch plain vs chunked vs flash by config / seq length
    (reference routing)."""
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
    return attention_chunked(cfg, p, x, causal=causal, window=window,
                             positions=positions)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


@by_rule(partition.write_slots)
def _write_slots(cache, slot, new):
    """``cache[b, slot[b]] = new[b]`` for every row b, in place."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    cache[bidx, slot] = new.to(cache.dtype)


def attention_decode(cfg: ModelConfig, p, x1, cache, pos, *, window=None,
                     cross_kv=None):
    """One-token decode against a KV cache.

    cache: {"k": (B, L, KV, hd), "v": (B, L, KV, hd)}; L = full seq for
    global layers, ring size for sliding-window layers.  Keys are stored
    post-RoPE.  ``pos``: (B,) current position (0-based index of the new
    token).  Returns (out (B,1,D), cache).

    The new K/V row is written into ``cache`` in place (the reference's
    ``.at[].set`` returns a new array); the returned cache is the same
    dict.  A caller that needs the old contents clones them first.
    """
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    if cross_kv is not None:
        # cross-attention: static precomputed K/V (encoder frames, no
        # position), no cache update; ``cache`` is returned as given
        q = x1 @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = split_dim(q, -1, (cfg.n_heads, hd))
        out = _sdpa(q, cross_kv["k"], cross_kv["v"], None,
                    1.0 / math.sqrt(hd))
        return merge_heads(out, p["wo"]) @ p["wo"], cache
    q, k_new, v_new = _project_qkv(cfg, p, x1)
    if cfg.pos_type == "rope":
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)

    k_cache, v_cache = cache["k"], cache["v"]
    L = k_cache.shape[1]
    # a global layer's slot is clamped to L - 1: past L new tokens the
    # reference overwrites its last slot, and so does the port (parity)
    slot = pos % L if window is not None else torch.clamp(pos, max=L - 1)
    _write_slots(k_cache, slot, k_new[:, 0])
    _write_slots(v_cache, slot, v_new[:, 0])

    if cfg.attn_impl in ("flash", "flash-ref") and window is None:
        # flash-decoding kernel: global layers keep a contiguous prefix
        # cache (slot s = position s), exactly the kernel's lengths
        # semantics.  Windowed ring buffers stay on the plain path below.
        from repro_torch.kernels.decode_attention.ops import decode_attention
        qd = q.reshape(B, -1, hd)                 # (B, H, hd)
        kd = k_cache.permute(0, 2, 1, 3)          # (B, KV, L, hd), a view
        vd = v_cache.permute(0, 2, 1, 3)
        impl = "ref" if cfg.attn_impl == "flash-ref" else "auto"
        out = decode_attention(qd, kd, vd, pos + 1, impl=impl)
        return out.reshape(B, 1, -1) @ p["wo"], cache

    # validity: which cache slots hold tokens visible to this query
    slot_ids = torch.arange(L, device=x1.device)[None, :]  # (1, L)
    if window is None:
        valid = slot_ids <= pos[:, None]
    else:
        # ring buffer: slot s holds absolute position p' = s (mod L), the
        # largest such p' <= pos; it is valid if pos - p' < window, p' >= 0
        delta = (pos[:, None] - slot_ids) % L  # age of entry in slots
        valid = delta < torch.clamp(pos[:, None] + 1, max=window)
    out = _sdpa(q, k_cache, v_cache, valid[:, None, None, None, :],
                1.0 / math.sqrt(hd))
    return merge_heads(out, p["wo"]) @ p["wo"], cache


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


# --------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bounded scatter dispatch)
# --------------------------------------------------------------------------


def _round_up(x, m):
    return (x + m - 1) // m * m


def _capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert takes of a group of T tokens."""
    K, E = cfg.top_k, cfg.n_experts
    return min(_round_up(max(1, int(K * T / E * cfg.capacity_factor)), 8), T)


@by_rule(partition.per_sequence(None, None, None, None))
def _route_from_probs(probs, K: int, C: int):
    """probs (B, T, E) -> topv, topi (B, T, K), keep, dst (B, T*K): the
    router's choices, ranked within each sequence (see ``moe_route``)."""
    B, T, E = probs.shape
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    flat_e = topi.reshape(B, T * K)
    onehot = F.one_hot(flat_e, E)                      # (B, T*K, E)
    ranks = torch.gather(torch.cumsum(onehot, dim=1), 2,
                         flat_e[..., None])[..., 0] - 1
    keep = ranks < C
    dst = torch.where(keep, flat_e * C + ranks, torch.full_like(ranks, E * C))
    return topv, topi, keep, dst


@by_rule(partition.per_sequence())
def _dispatch(x, dst, E: int, C: int, K: int):
    """x (B, T, D) -> each sequence's (E, C, D) expert buffer: slot k of
    token t goes to row ``dst[b, t*K + k]``; rows at the sentinel E*C are
    thrown away."""
    B, T, D = x.shape
    x_rep = torch.repeat_interleave(x, K, dim=1)       # (B, T*K, D)
    buf = x.new_zeros((B, E * C + 1, D))
    bidx = torch.arange(B, device=x.device)[:, None]
    buf[bidx, dst] = x_rep
    return buf[:, :E * C].reshape(B, E, C, D)


@by_rule(partition.per_sequence())
def _combine(out_buf, dst, topv):
    """Each token's K expert outputs read back from ``out_buf`` (B, E, C,
    D) at ``dst`` (a dropped slot reads zeros) and summed with the
    renormalised router weights -> (B, T, D)."""
    B, E, C, D = out_buf.shape
    T, K = topv.shape[1], topv.shape[2]
    out_flat = torch.cat([out_buf.reshape(B, E * C, D),
                          out_buf.new_zeros((B, 1, D))], dim=1)
    bidx = torch.arange(B, device=out_buf.device)[:, None]
    gathered = out_flat[bidx, dst]                     # (B, T*K, D)
    return torch.sum(gathered.reshape(B, T, K, D)
                     * topv[..., None].to(out_buf.dtype), dim=2)


@by_rule(partition.per_sequence(partition.partial_where_sharded))
def _first_choice_counts(topi, E: int):
    """Tokens whose first choice is each expert -> (E,) float32."""
    return torch.sum(F.one_hot(topi[..., 0], E).float(), dim=(0, 1))


def _expert_up(buf, w_gate, w_up):
    """The gate and up products of every expert over its (B, C, D) rows
    of ``buf`` (B, E, C, D) -> g, u (B, E, C, F)."""
    return (torch.einsum("becd,edf->becf", buf, w_gate),
            torch.einsum("becd,edf->becf", buf, w_up))


def _expert_down(g, u, w_down):
    """SiLU(g) * u through each expert's down product -> (B, E, C, D)."""
    h = F.silu(g.float()).to(g.dtype) * u
    h = shard_act(h, ("batch", "experts", None, "ffn"))
    return torch.einsum("becf,efd->becd", h, w_down)


@by_rule(partition.experts(_expert_up, _expert_down))
def _experts(buf, w_gate, w_up, w_down):
    """Every expert's SwiGLU over its (B, C, D) rows of ``buf`` (B, E, C,
    D): batched products over the experts, in the model type."""
    return _expert_down(*_expert_up(buf, w_gate, w_up), w_down)


def moe_route(cfg: ModelConfig, p, x):
    """The router of ``moe_ffn_tokens``: x (B, T, D) -> probs (B,T,E) f32,
    renormalised top-k weights topv (B,T,K) f32, experts topi (B,T,K),
    capacity C, keep (B,T*K) bool and dispatch rows dst (B,T*K).

    Top-k is a stable descending sort, so on ties the lower expert index
    comes first, as ``lax.top_k`` puts it (``torch.topk`` promises no
    order).  Each (token, slot) is ranked within its expert in the flat
    T*K order of its own sequence; ranks >= C go to the sentinel row E*C.
    """
    T = x.shape[1]
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    C = _capacity(cfg, T)
    topv, topi, keep, dst = _route_from_probs(probs, K=cfg.top_k, C=C)
    return probs, topv, topi, C, keep, dst


def moe_ffn_tokens(cfg: ModelConfig, p, x):
    """MoE over batched capacity groups x (B, T, D) -> (B, T, D), plus the
    Switch load-balance aux (a float32 scalar).

    Every sequence dispatches into its own (E, C, D) buffer (GShard groups
    = the batch rows); tokens that overflow an expert's capacity are
    dropped (contribute zero).  The expert products are plain batched
    matmuls over the experts, in the model type.  Partitioned, the
    buffer is split over the experts' axis (and, where the batch splits
    over no mesh dim, over its D columns as the weights' "embed" shard
    is), each rank's own slice of a dispatch it computes whole, and
    gathered whole for the combine.
    """
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, topv, topi, C, _, dst = moe_route(cfg, p, x)

    buf = _dispatch(x, dst, E=E, C=C, K=K)
    buf = shard_act(buf, ("batch", "experts", None, None))

    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"])
    out_buf = shard_act(out_buf, ("batch", "experts", None, None))
    out = _combine(out_buf, dst, topv)

    # aux: load-balance loss (Switch) — mean fraction * mean prob per expert
    frac = _first_choice_counts(topi, E=E) / (B * T)
    imp = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac * imp)
    return out, aux


def apply_moe(cfg: ModelConfig, p, x):
    """x (B,S,D) -> ((B,S,D), aux); over S-chunks of ``cfg.moe_chunk`` when
    0 < moe_chunk < S and S % moe_chunk == 0 (capacity group = sequence x
    chunk; the aux is the mean over chunks)."""
    B, S, D = x.shape
    chunk = cfg.moe_chunk
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        return moe_ffn_tokens(cfg, p, x)
    nch = S // chunk
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nch):
        out, a = moe_ffn_tokens(cfg, p, x[:, c * chunk:(c + 1) * chunk])
        outs.append(out)
        aux = aux + a
    return torch.cat(outs, dim=1), aux / nch


# --------------------------------------------------------------------------
# Mamba-1 (selective scan)
# --------------------------------------------------------------------------


def _in_proj(cfg, p, x):
    """x (B,S,D) -> (x, the gate z), each (B,S,di): in_proj's two halves,
    each its own product split over "inner" (partitioned, a chunk of
    the whole product, split over "inner" as one dim, would gather it
    whole on every rank)."""
    w, di = p["in_proj"], cfg.d_inner
    return [shard_act(x @ shard_act(half, ("embed", "inner")),
                      ("batch", None, "inner"))
            for half in (w[:, :di], w[:, di:])]


def _mamba_gates(cfg, p, xr):
    """Common pre-scan computation: xr (B,S,di) -> dt, Bc, Cc (float32)."""
    dr, ds = cfg.dt_rank, cfg.ssm_state
    # x_proj contracts the inner dim: partitioned over "inner", the
    # product is a Partial sum, reduced here (it is small) rather than
    # carried into the scan's (B, chunk, di, ds) tensors
    dbc = shard_act((xr @ p["x_proj"]).float(),
                    ("batch", None, None))             # (B,S,dr+2ds)
    dt_low, Bc, Cc = torch.split(dbc, [dr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].float()
                    + p["dt_bias"])
    return dt, Bc, Cc                      # (B,S,di), (B,S,ds), (B,S,ds)


def _scan_takes_the_kernel(*tensors) -> bool:
    """Whether ``mamba_scan`` runs its scan through K6's op
    (``kernels.selective_scan.ops``: the kernel on a CUDA tensor, its
    plain version on a CPU one).  The layer's chunked recurrence
    (``selective_scan_ref`` with its backward, its partition rule and its
    meta stand-in) takes the rest: a DTensor (the partitioned program), a
    meta tensor (the dry run) and autograd recording (training; K6 has no
    backward)."""
    return not (any(isinstance(t, DTensor) or t.is_meta for t in tensors)
                or (torch.is_grad_enabled()
                    and any(t.requires_grad for t in tensors)))


def mamba_scan(cfg: ModelConfig, p, x, h0=None, conv0=None):
    """Full-sequence Mamba: x (B,S,D) -> (y (B,S,D), (h_final, conv_state)).

    The selective scan runs on K6 where ``_scan_takes_the_kernel``, else
    on the chunked recurrence (``cfg.ssm_chunk`` positions a chunk, which
    bound the (B, chunk, d_inner, ssm_state) intermediates as the
    reference's does); each call adds one to the tracer's counter
    ``mamba.scan_kernel`` or ``mamba.scan_plain``, by the route taken.
    """
    B, S, D = x.shape
    di, dc = cfg.d_inner, cfg.ssm_conv
    xr, z = _in_proj(cfg, p, x)                        # (B,S,di) each

    # causal depthwise conv along S
    pad = (x.new_zeros((B, dc - 1, di)) if conv0 is None
           else conv0.to(xr.dtype))
    xp = torch.cat([pad, xr], dim=1)                   # (B, S+dc-1, di)
    conv_state = xp[:, -(dc - 1):, :].clone() if dc > 1 else None
    xc = sum(xp[:, i:i + S, :] * p["conv_w"][i] for i in range(dc)) \
        + p["conv_b"]
    xc = F.silu(xc.float()).to(x.dtype)
    xc = shard_act(xc, ("batch", None, "inner"))

    dt, Bc, Cc = _mamba_gates(cfg, p, xc)
    dt = shard_act(dt, ("batch", None, "inner"))
    A = -torch.exp(p["A_log"])                         # (di, ds)
    args = (xc, dt, Bc, Cc, z, A, p["D"])
    given = args if h0 is None else (*args, h0)
    if _scan_takes_the_kernel(*given):
        get_tracer().metrics.inc("mamba.scan_kernel")
        y, h = selective_scan(*args, h0, chunk=cfg.ssm_chunk)
    else:
        get_tracer().metrics.inc("mamba.scan_plain")
        # as the reference's remat_inner: where autograd records, each
        # chunk's (B, chunk, di, ds) stacks are recomputed in the backward
        remat = cfg.remat_inner and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, Bc, Cc, A, *given[7:]))
        y, h = selective_scan_ref(*args, h0, chunk=cfg.ssm_chunk,
                                  remat=remat)
    return y @ p["out_proj"], (h, conv_state)


def mamba_decode(cfg: ModelConfig, p, x1, state):
    """One-token Mamba step. state = {"h": (B,di,ds) f32, "conv":
    (B,dc-1,di)} -> (out (B,1,D), new state); ``state`` is not changed."""
    xr, z = _in_proj(cfg, p, x1)                       # (B,1,di) each
    window = torch.cat([state["conv"].to(xr.dtype), xr], dim=1)  # (B,dc,di)
    new_conv = window[:, 1:, :]
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc.float()).to(x1.dtype)[:, None, :]  # (B,1,di)

    dt, Bc, Cc = _mamba_gates(cfg, p, xc)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)               # (B,di,ds)
    b = (dt[:, 0] * xc[:, 0].float())[..., None] * Bc[:, 0, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cc[:, 0]) + p["D"] * xc[:, 0].float()
    y = (y[:, None, :] * F.silu(z.float())).to(x1.dtype)
    return y @ p["out_proj"], {"h": h,
                               "conv": new_conv.to(state["conv"].dtype)}
