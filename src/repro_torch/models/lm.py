"""Decoder LM, dense subset: forward, hidden states, yes/no logit select.

Parameters are plain nested dicts of tensors with the reference's names.
The reference stacks the superblocks along a leading axis and scans over
them; here ``params["blocks"]`` is a list with one dict per superblock and
the forward is a Python loop over layers.  Decode, Mamba, MoE,
encoder-decoder and prefix embeddings are later slices of the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.utils.device import resolve_device


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.ffn not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported yet (Mamba and MoE "
                "come with the model zoo, ROADMAP.md queue 1)")
    if cfg.is_encdec or cfg.num_prefix_embeds or cfg.pos_type != "rope":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, prefix and sinusoidal models are "
            "not ported yet (ROADMAP.md queue 1)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec):
    """(name path, shape, init) of one layer's tensors, in the reference's
    names; ``init`` is "ones" (norm scale), "zeros" (bias) or the fan-in
    of a dense weight."""
    D, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out = [(("norm", "scale"), (D,), "ones"),
           (("attn", "wq"), (D, H * hd), D), (("attn", "wk"), (D, KV * hd), D),
           (("attn", "wv"), (D, KV * hd), D), (("attn", "wo"), (H * hd, D),
                                               H * hd)]
    if cfg.qkv_bias:
        out += [(("attn", "bq"), (H * hd,), "zeros"),
                (("attn", "bk"), (KV * hd,), "zeros"),
                (("attn", "bv"), (KV * hd,), "zeros")]
    if spec.ffn == "dense":
        out.append((("ffn_norm", "scale"), (D,), "ones"))
        if cfg.mlp_type == "gelu":
            out += [(("ffn", "w_in"), (D, F), D), (("ffn", "b_in"), (F,), "zeros"),
                    (("ffn", "w_out"), (F, D), F), (("ffn", "b_out"), (D,), "zeros")]
        else:
            out += [(("ffn", "w_gate"), (D, F), D), (("ffn", "w_up"), (D, F), D),
                    (("ffn", "w_down"), (F, D), F)]
    return out


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights on ``device`` in ``cfg.dtype``, one tensor at a time.

    Dense weights are normal with std 1/sqrt(fan_in) as in the reference;
    norm scales are ones and biases zeros.  ``generator`` must live on
    ``device`` (``torch.Generator(device="cuda")`` for the card).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    D, Vp = cfg.d_model, cfg.padded_vocab

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(1.0 / math.sqrt(max(1, fan_in))).to(dt)

    params = {"embed": {"table": normal((Vp, D), D)}, "blocks": []}
    for _ in range(cfg.n_superblocks):
        sb = {}
        for i, spec in enumerate(cfg.pattern):
            layer: dict = {}
            for path, shape, init in _layer_shapes(cfg, spec):
                if init == "ones":  # norm scales stay float32
                    t = torch.ones(shape, dtype=torch.float32, device=dev)
                elif init == "zeros":
                    t = torch.zeros(shape, dtype=dt, device=dev)
                else:
                    t = normal(shape, init)
                _put(layer, path, t)
            sb[f"l{i}"] = layer
        params["blocks"].append(sb)
    params["final_norm"] = {"scale": torch.ones((D,), dtype=torch.float32,
                                                device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal((Vp, D), Vp)}
    return params


def params_from_jax(cfg: ModelConfig, np_tree: dict, device="cuda") -> dict:
    """The reference's ``lm.init_params`` tree (numpy arrays, superblocks
    stacked on a leading axis) as the port's parameters on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.tensor(a, device=dev)

    def slice_tree(t, i):
        if isinstance(t, dict):
            return {k: slice_tree(v, i) for k, v in t.items()}
        return conv(np.asarray(t)[i])

    params = {k: {n: conv(a) for n, a in v.items()}
              for k, v in np_tree.items() if k != "blocks"}
    params["blocks"] = [slice_tree(np_tree["blocks"], i)
                        for i in range(cfg.n_superblocks)]
    return params


# --------------------------------------------------------------------------
# forward (full sequence)
# --------------------------------------------------------------------------


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p, h, positions):
    hn = L.apply_norm(cfg, p["norm"], h)
    h = h + L.attention_apply(cfg, p["attn"], hn, causal=True,
                              window=spec.window, positions=positions)
    if spec.ffn == "dense":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        h = h + L.apply_mlp(cfg, p["ffn"], hf)
    return h


def _lm_table(cfg: ModelConfig, params):
    return (params["lm_head"]["w"] if not cfg.tie_embeddings
            else params["embed"]["table"])


def forward_hidden(cfg: ModelConfig, params, tokens):
    """Full-sequence forward up to the final hidden states -> (h, aux)."""
    _check_supported(cfg)
    h = params["embed"]["table"][tokens]
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    for sb in params["blocks"]:
        for i, spec in enumerate(cfg.pattern):
            h = _apply_layer(cfg, spec, sb[f"l{i}"], h, positions)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def first_logits_select(cfg: ModelConfig, params, tokens, lens, token_ids):
    """Last-position logits for selected vocab ids only -> (B, T) float32.

    ``token_ids`` is (T,) shared across the batch or (B, T) per prompt;
    ``lens`` (B,) true prompt lengths.
    """
    h, _ = forward_hidden(cfg, params, tokens)
    hl = h[torch.arange(h.shape[0], device=h.device), lens - 1]  # (B, D)
    hl = L.apply_norm(cfg, params["final_norm"], hl)
    rows = _lm_table(cfg, params)[token_ids]       # (T, D) or (B, T, D)
    if rows.ndim == 3:
        return torch.einsum("bd,btd->bt", hl.float(), rows.float())
    return torch.einsum("bd,td->bt", hl.float(), rows.float())


def forward(cfg: ModelConfig, params, tokens):
    """Full-sequence forward -> (logits (B,S,Vp) float32, aux)."""
    h, aux = forward_hidden(cfg, params, tokens)
    h = L.apply_norm(cfg, params["final_norm"], h)
    table = _lm_table(cfg, params)
    return torch.einsum("bsd,vd->bsv", h.float(), table.float()), aux
