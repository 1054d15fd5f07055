"""The decoder layout of ``jamba-v0.1-52b`` and ``internvl2-26b``: one
architecture module, the default of a configuration file without an
``"arch"`` key.

A layer is a mixer, grouped-query attention with rotate-half RoPE or
Mamba-1, and an FFN, SwiGLU or top-k MoE, each behind an RMSNorm, laid
out by Jamba-style period/offset keys (a configuration without them is
attention and dense throughout).  The module gives the harness what
depends on that layout, found by ``spec.arch``: the flat sizes
(``dims``), the program's ``ModelConfig``, the cut to CPU test size,
the weights, the plain float32 reference and the FLOP count.

Weights (``make_params``) are random, on the device, from the run's
seed, in the program's parameter tree (``embed.table``,
``blocks[s]["l{i}"]`` by superblock, ``final_norm``, ``lm_head.w`` when
untied; the layers' names as the program's).  Every normal weight of the
served dtype is a view into one buffer filled by one ``randn`` call,
scaled to std 1/sqrt(fan-in); the float32 router weights share a second
buffer.  Norm scales are ones, Mamba's A_log is log(1..d_state) on every
row, D ones, dt_bias -4.6 (softplus^-1(0.01)), conv bias zeros.  The
benchmark hands these same tensors to the program and to the reference.

The reference (``yes_no_logits``) gives a decoder's yes/no logits at
each prompt's last position, in float32, layer by layer over a block of
prompts padded as the program served them.  It follows the
configuration file: RMSNorm; grouped-query causal attention with
rotate-half RoPE; Mamba-1 (in_proj split into x and the gate z, a causal
depthwise conv with bias, SiLU, x_proj into dt, B and C, dt =
softplus(dt_low dt_proj + dt_bias), h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t, y = C h + D x, y * SiLU(z), out_proj); SwiGLU FFNs; top-k MoE with
renormalised router weights, each sequence's (token, slot) pairs ranked
per expert in token order and those past the capacity ``spec.capacity``
dropped (or, given a ``Route``, the experts that the program chose,
weighted by this router, each choice checked against this router's
own); a final RMSNorm and the product with the yes and no rows of the
output table.  Departures of this layout from the published models are
listed in PERF.md.  It imports nothing of the program.

The FLOP count (``prefill_flops``) is the useful work: real tokens only,
causal attention over the (query, key) pairs a prompt has, MoE at its
top-k experts, a head of the two logits read.  ``executed=True`` counts
instead what the program's operations multiply, as ``launch.op_cost``
sees them: every padded position, the whole score square, every
capacity slot of every expert, and of Mamba's scan only its one product
(C . h); the tests hold that form against op_cost.  A multiply-add is 2
FLOPs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchkit.data import stream_seed
from benchkit.reference import Route, _Ops
from benchkit.spec import capacity, period


# ------------------------------------------------------------------ sizes
def layer_kinds(conf: dict) -> list:
    """[(mixer, ffn)] for every layer: mixer "attn" or "mamba", ffn
    "dense" or "moe", from Jamba-style period/offset keys (a config
    without them is attention and dense throughout)."""
    n = conf["num_hidden_layers"]
    out = []
    for i in range(n):
        mixer = "attn"
        if "attn_layer_period" in conf:
            p, o = conf["attn_layer_period"], conf["attn_layer_offset"]
            mixer = "attn" if i % p == o else "mamba"
        ffn = "dense"
        if conf.get("num_experts", 1) > 1:
            p, o = conf["expert_layer_period"], conf["expert_layer_offset"]
            ffn = "moe" if i % p == o else "dense"
        out.append((mixer, ffn))
    return out


def dims(conf: dict) -> dict:
    """The sizes both sides use, in one flat dict."""
    D = conf["hidden_size"]
    H = conf["num_attention_heads"]
    d = {"D": D, "H": H, "KV": conf["num_key_value_heads"],
         "hd": conf.get("head_dim") or D // H,
         "F": conf["intermediate_size"], "V": conf["vocab_size"],
         "E": conf.get("num_experts", 1), "K": conf.get("num_experts_per_tok", 1),
         "eps": conf["rms_norm_eps"], "theta": conf["rope_theta"],
         "tied": conf["tie_word_embeddings"],
         "cf": conf["serving"]["capacity_factor"],
         "layers": layer_kinds(conf)}
    if "mamba_d_state" in conf:
        d.update(ds=conf["mamba_d_state"], dc=conf["mamba_d_conv"],
                 di=conf["mamba_expand"] * D, dr=conf["mamba_dt_rank"])
    d["Vp"] = (d["V"] + 127) // 128 * 128   # the program pads its table
    return d


def program_config(conf: dict, d: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    kinds = d["layers"]
    p = period(kinds)
    srv = conf["serving"]
    mcfg = ModelConfig(
        name=conf["name"], family=srv["family"], n_layers=len(kinds),
        d_model=d["D"], n_heads=d["H"], n_kv_heads=d["KV"], d_ff=d["F"],
        vocab_size=d["V"], head_dim=d["hd"],
        pattern=tuple(LayerSpec(kind=m, ffn=f) for m, f in kinds[:p]),
        n_experts=d["E"] if d["E"] > 1 else 0,
        top_k=d["K"] if d["E"] > 1 else 0,
        capacity_factor=d["cf"], ssm_state=d.get("ds", 16),
        ssm_conv=d.get("dc", 4),
        ssm_expand=conf.get("mamba_expand", 2), rope_theta=d["theta"],
        norm_eps=d["eps"], dtype=srv["dtype"], tie_embeddings=d["tied"],
        attn_impl=srv["attn_impl"], moe_chunk=srv["moe_chunk"])
    if "dr" in d and mcfg.dt_rank != d["dr"]:
        raise ValueError(f"the program derives dt_rank {mcfg.dt_rank}, the "
                         f"configuration states {d['dr']}")
    return mcfg


SMOKE_WIDTHS = dict(hidden_size=64, intermediate_size=128,
                    num_attention_heads=4, num_key_value_heads=2,
                    vocab_size=512)


def smoke(conf: dict) -> None:
    """Cut ``conf`` in place to CPU test size: widths 64, and with Mamba
    8 layers (one Jamba period), 4 experts and dt_rank 4, else 2
    layers."""
    conf.update(SMOKE_WIDTHS)
    if "mamba_d_state" in conf:
        conf.update(num_hidden_layers=8, num_experts=4, mamba_dt_rank=4)
    else:
        conf.update(num_hidden_layers=2)


# ---------------------------------------------------------------- weights
def _shapes(d: dict, mixer: str, ffn: str) -> list:
    """(path, shape, fan_in) of one layer's normal weights."""
    D, F = d["D"], d["F"]
    out = []
    if mixer == "attn":
        hq, hk = d["H"] * d["hd"], d["KV"] * d["hd"]
        out += [(("attn", "wq"), (D, hq), D), (("attn", "wk"), (D, hk), D),
                (("attn", "wv"), (D, hk), D), (("attn", "wo"), (hq, D), hq)]
    else:
        di, ds, dr, dc = d["di"], d["ds"], d["dr"], d["dc"]
        out += [(("mamba", "in_proj"), (D, 2 * di), D),
                (("mamba", "conv_w"), (dc, di), dc),
                (("mamba", "x_proj"), (di, dr + 2 * ds), di),
                (("mamba", "dt_proj"), (dr, di), dr),
                (("mamba", "out_proj"), (di, D), di)]
    if ffn == "dense":
        out += [(("ffn", "w_gate"), (D, F), D), (("ffn", "w_up"), (D, F), D),
                (("ffn", "w_down"), (F, D), F)]
    else:
        E = d["E"]
        out += [(("moe", "w_gate"), (E, D, F), D), (("moe", "w_up"), (E, D, F), D),
                (("moe", "w_down"), (E, F, D), F)]
    return out


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(d: dict, seed: int, dtype, device) -> dict:
    """The whole tree; ``d`` is ``dims`` of the configuration."""
    D, Vp = d["D"], d["Vp"]
    plan = [(("embed", "table"), (Vp, D), D)]
    if not d["tied"]:
        plan.append((("lm_head", "w"), (Vp, D), D))
    for i, (mixer, ffn) in enumerate(d["layers"]):
        plan += [((i,) + p, s, f) for p, s, f in _shapes(d, mixer, ffn)]
    routers = [((i, "moe", "router"), (D, d["E"]), D)
               for i, (_, ffn) in enumerate(d["layers"]) if ffn == "moe"]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 3))
    flat = torch.randn((sum(math.prod(s) for _, s, _ in plan),),
                       generator=g, dtype=dtype, device=device)
    rflat = torch.randn((sum(math.prod(s) for _, s, _ in routers),),
                        generator=g, dtype=torch.float32, device=device)
    layers = [{} for _ in d["layers"]]
    tree: dict = {}
    for buf, entries in ((flat, plan), (rflat, routers)):
        off = 0
        for path, shape, fan_in in entries:
            n = math.prod(shape)
            w = buf[off:off + n].view(shape)
            w.mul_(1.0 / math.sqrt(fan_in))
            off += n
            if isinstance(path[0], int):
                _put(layers[path[0]], path[1:], w)
            else:
                _put(tree, path, w)
    f32 = dict(dtype=torch.float32, device=device)
    for layer, (mixer, ffn) in zip(layers, d["layers"]):
        layer["norm"] = {"scale": torch.ones(D, **f32)}
        layer["ffn_norm"] = {"scale": torch.ones(D, **f32)}
        if mixer == "mamba":
            m = layer["mamba"]
            di, ds = d["di"], d["ds"]
            m["conv_b"] = torch.zeros(di, dtype=dtype, device=device)
            m["dt_bias"] = torch.full((di,), -4.6, **f32)
            m["A_log"] = torch.log(torch.arange(1, ds + 1, **f32)).expand(
                di, ds).clone()
            m["D"] = torch.ones(di, **f32)
    tree["final_norm"] = {"scale": torch.ones(D, **f32)}
    p = period(d["layers"])
    tree["blocks"] = [{f"l{j}": layers[s * p + j] for j in range(p)}
                      for s in range(len(layers) // p)]
    return tree


def layer_list(tree: dict) -> list:
    """The layers in order, from the program's superblock layout."""
    out = []
    for sb in tree["blocks"]:
        out += [sb[f"l{j}"] for j in range(len(sb))]
    return out


# -------------------------------------------------------------- reference
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


# ------------------------------------------------------------------ FLOPs
def attn_flops(d: dict, n_tok: int, pairs: int) -> int:
    """Projections of ``n_tok`` tokens, products over ``pairs`` (q, k)."""
    D, H, KV, hd = d["D"], d["H"], d["KV"], d["hd"]
    return n_tok * 2 * D * hd * (2 * H + 2 * KV) + 4 * H * hd * pairs


def mamba_flops(d: dict, n_tok: int, executed: bool = False) -> int:
    D, di, ds, dr, dc = d["D"], d["di"], d["ds"], d["dr"], d["dc"]
    proj = 2 * D * 2 * di + 2 * di * (dr + 2 * ds) + 2 * dr * di + 2 * di * D
    scan = 2 * di * ds if executed else 9 * di * ds + 2 * dc * di
    return n_tok * (proj + scan)


def ffn_flops(d: dict, n_tok: int) -> int:
    return n_tok * 6 * d["D"] * d["F"]


def moe_flops(d: dict, n_tok: int, slots: int) -> int:
    """Router for ``n_tok`` tokens, SwiGLU experts over ``slots`` rows."""
    return n_tok * 2 * d["D"] * d["E"] + ffn_flops(d, slots)


def head_flops(d: dict, n_rows: int, n_logits: int = 2) -> int:
    return n_rows * 2 * d["D"] * n_logits


def prefill_flops(d: dict, lens, T: int = 0, executed: bool = False) -> int:
    """FLOPs of one yes/no prefill of prompts of ``lens`` tokens (padded
    to ``T`` when ``executed``)."""
    total = 0
    for L in lens:
        L = int(L)
        n = T if executed else L
        pairs = n * n if executed else L * (L + 1) // 2
        slots = (d["E"] * capacity(d["K"], n, d["E"], d["cf"]) if executed
                 else L * d["K"])
        for mixer, ffn in d["layers"]:
            total += (attn_flops(d, n, pairs) if mixer == "attn"
                      else mamba_flops(d, n, executed))
            total += moe_flops(d, n, slots) if ffn == "moe" else ffn_flops(d, n)
        total += head_flops(d, 1)
    return total
