"""Random weights on the device from the run's seed, in the program's
parameter tree (``embed.table``, ``blocks[s]["l{i}"]`` by superblock,
``final_norm``, ``lm_head.w`` when untied; the layers' names as the
program's).  Every normal weight of the served dtype is a view into one
buffer filled by one ``randn`` call, scaled to std 1/sqrt(fan-in); the
float32 router weights share a second buffer.  Norm scales are ones,
Mamba's A_log is log(1..d_state) on every row, D ones, dt_bias -4.6
(softplus^-1(0.01)), conv bias zeros.  The benchmark hands these same
tensors to the program and to the reference."""
from __future__ import annotations

import math

import torch

from benchkit.data import stream_seed
from benchkit.spec import period


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
    """The whole tree; ``d`` is ``spec.dims`` of the configuration."""
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
