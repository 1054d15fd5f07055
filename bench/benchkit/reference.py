"""The plain reference forward: a decoder's yes/no logits at each
prompt's last position, in float32, layer by layer over a block of
prompts padded as the program served them.

It follows the configuration file: RMSNorm; grouped-query causal
attention with rotate-half RoPE; Mamba-1 (in_proj split into x and the
gate z, a causal depthwise conv with bias, SiLU, x_proj into dt, B and C,
dt = softplus(dt_low dt_proj + dt_bias), h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t, y = C h + D x, y * SiLU(z), out_proj); SwiGLU FFNs; top-k
MoE with renormalised router weights, each sequence's (token, slot)
pairs ranked per expert in token order and those past the capacity
``spec.capacity`` dropped (or, given a ``Route``, the experts that the
program chose, weighted by this router, each choice checked against
this router's own); a final RMSNorm and the product with the yes
and no rows of the output table.  Departures of this layout from the
published models are listed in PERF.md.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale a tensor (its largest magnitude at 448), sums
in float32.  Weights are read as given (the served bfloat16 tensors) and
widened one layer, or one expert, at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchkit.spec import capacity


def _q8(x):
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def w(self, t):
        t = t.float()
        return _q8(t) if self.fp8 else t

    def a(self, t):
        return _q8(t) if self.fp8 else t

    def mm(self, x, w):
        return self.a(x) @ self.w(w)

    def einsum(self, eq, x, y):
        return torch.einsum(eq, self.a(x), self.a(y))


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * \
        scale.float()


def _rope(x, theta):
    """x (B, T, n, hd): rotate-half RoPE at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(op, d, p, x):
    B, T, _ = x.shape
    H, KV, hd = d["H"], d["KV"], d["hd"]
    q = _rope(op.mm(x, p["wq"]).view(B, T, H, hd), d["theta"])
    k = _rope(op.mm(x, p["wk"]).view(B, T, KV, hd), d["theta"])
    v = op.mm(x, p["wv"]).view(B, T, KV, hd)
    q = q.view(B, T, KV, H // KV, hd)
    s = op.einsum("bqcgh,bkch->bcgqk", q, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = op.einsum("bcgqk,bkch->bqcgh", torch.softmax(s, -1), v)
    return op.mm(o.reshape(B, T, H * hd), p["wo"])


def _mamba(op, d, p, x):
    B, T, _ = x.shape
    di, ds, dr, dc = d["di"], d["ds"], d["dr"], d["dc"]
    xz = op.mm(x, p["in_proj"])
    xr, z = xz[..., :di], xz[..., di:]
    xp = torch.cat([xr.new_zeros(B, dc - 1, di), xr], 1)
    cw = p["conv_w"].float()
    xc = sum(xp[:, i:i + T] * cw[i] for i in range(dc)) + p["conv_b"].float()
    xc = F.silu(xc)
    dbc = op.mm(xc, p["x_proj"])
    dt_low, Bc, Cc = dbc[..., :dr], dbc[..., dr:dr + ds], dbc[..., dr + ds:]
    dt = F.softplus(op.mm(dt_low, p["dt_proj"]) + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    h = x.new_zeros(B, di, ds)
    ys = []
    for t in range(T):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xc[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    y = torch.stack(ys, 1) + p["D"].float() * xc
    return op.mm(y * F.silu(z), p["out_proj"])


def _swiglu(op, x, wg, wu, wd):
    return op.mm(F.silu(op.mm(x, wg)) * op.mm(x, wu), wd)


def _moe(op, d, p, x, route=None):
    """``route`` (a ``Route``) gives the experts to dispatch to, where it
    has them, and gets this layer's own choice and the tokens whose
    given experts this router does not allow."""
    B, T, D = x.shape
    E, K = d["E"], d["K"]
    logits = op.mm(x, p["router"])
    probs = torch.softmax(logits, -1)
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :K]
    if route is not None:
        topi = route.step(logits, topi)
    topv = probs.gather(-1, topi)
    topv = topv / topv.sum(-1, keepdim=True)
    flat = topi.reshape(B, T * K)
    rank = torch.cumsum(F.one_hot(flat, E), 1).gather(2, flat[..., None])[..., 0] - 1
    keep = (rank < capacity(K, T, E, d["cf"])).reshape(B, T, K)
    out = torch.zeros_like(x)
    xf = x.reshape(B * T, D)
    for e in range(E):
        hit = (topi == e) & keep                        # (B, T, K)
        rows = hit.any(-1).reshape(-1).nonzero()[:, 0]
        if len(rows) == 0:
            continue
        wgt = (topv * hit).sum(-1).reshape(-1)[rows]
        y = _swiglu(op, xf[rows], p["w_gate"][e], p["w_up"][e],
                    p["w_down"][e])
        out.view(B * T, D).index_add_(0, rows, y * wgt[:, None])
    return out


class Route:
    """The experts of each MoE layer in turn, given and chosen.

    ``given``: one (B, T, K) tensor a MoE layer, the experts to dispatch
    to (-1 where this forward chooses its own), or None to choose
    throughout.  After the forward, ``chosen`` holds each layer's own
    choice and ``excess`` each layer's (B, T) distance by which the
    lowest of a token's given experts lies below this router's K-th
    largest logit (0 where it does not): a choice that this router's
    rounding within ``tau`` could make has an excess of at most ``tau``."""

    def __init__(self, given=None):
        self.given = given
        self.chosen, self.excess = [], []

    def step(self, logits, own):
        self.chosen.append(own)
        if self.given is None:
            return own
        g = self.given[len(self.chosen) - 1]
        topi = torch.where(g >= 0, g, own)
        K = own.shape[-1]
        kth = torch.topk(logits, K, dim=-1).values[..., K - 1]
        low = logits.gather(-1, topi).min(-1).values
        self.excess.append((kth - low).clamp_min(0))
        return topi


def yes_no_logits(d: dict, params: dict, layers: list, tokens, lens,
                  token_ids, precision: str = "f32", route: Route = None):
    """tokens (B, T) long, padded on the right; lens (B,); token_ids (2,)
    -> (B, 2) float32.  ``layers`` are the layer dicts in order; a
    ``route`` gives and records the MoE layers' experts."""
    op = _Ops(precision)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            h = params["embed"]["table"][tokens].float()
            for p, (mixer, ffn) in zip(layers, d["layers"]):
                hn = _rms(h, p["norm"]["scale"], d["eps"])
                h = h + (_attention(op, d, p["attn"], hn) if mixer == "attn"
                         else _mamba(op, d, p["mamba"], hn))
                hn = _rms(h, p["ffn_norm"]["scale"], d["eps"])
                if ffn == "moe":
                    h = h + _moe(op, d, p["moe"], hn, route)
                else:
                    f = p["ffn"]
                    h = h + _swiglu(op, hn, f["w_gate"], f["w_up"],
                                    f["w_down"])
            last = h[torch.arange(len(lens), device=h.device), lens - 1]
            last = _rms(last, params["final_norm"]["scale"], d["eps"])
            table = (params["embed"]["table"] if d["tied"]
                     else params["lm_head"]["w"])
            return op.mm(last, table[token_ids].T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
