"""Decoder LM, dense subset: forward, yes/no logit select, prefill and
decode over a KV cache.

Parameters are plain nested dicts of tensors with the reference's names.
The reference stacks the superblocks along a leading axis and scans over
them; here ``params["blocks"]`` is a list with one dict per superblock and
the forward is a Python loop over layers.  The decode cache follows the
same layout: a list with one ``{"l{i}": {"k", "v"}}`` dict per
superblock.  ``init_layer`` and ``encoder_params_from_jax`` also serve the
bidirectional encoder (``repro_torch.embeddings.encoder``).  Mamba, MoE,
encoder-decoder and prefix embeddings are later slices of the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.utils.device import resolve_device


def _check_supported(cfg: ModelConfig, encoder: bool = False) -> None:
    """Refuse what the port cannot run.  The ``encoder`` family (the
    embedding encoder, sinusoidal positions) is admitted only where the
    encoder asks for it (``encoder=True``); the decoder paths refuse it."""
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.ffn not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer {spec} is not ported yet (Mamba and MoE "
                "come with the model zoo, ROADMAP.md queue 1)")
    if encoder:
        if cfg.family != "encoder":
            raise ValueError(f"{cfg.name}: not an encoder config "
                             f"(family {cfg.family!r})")
        return
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.name}: an encoder config runs through "
                         "repro_torch.embeddings.encoder, not the decoder")
    if cfg.is_encdec or cfg.num_prefix_embeds or cfg.pos_type != "rope":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, prefix and sinusoidal models are "
            "not ported yet (ROADMAP.md queue 1)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec):
    """(name path, shape, init) of one layer's tensors, in the reference's
    names; ``init`` is "ones" (norm scale), "norm_bias" (LayerNorm bias),
    "zeros" (bias) or the fan-in of a dense weight."""
    D, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out = _norm_shapes(cfg, "norm") + [
           (("attn", "wq"), (D, H * hd), D), (("attn", "wk"), (D, KV * hd), D),
           (("attn", "wv"), (D, KV * hd), D), (("attn", "wo"), (H * hd, D),
                                               H * hd)]
    if cfg.qkv_bias:
        out += [(("attn", "bq"), (H * hd,), "zeros"),
                (("attn", "bk"), (KV * hd,), "zeros"),
                (("attn", "bv"), (KV * hd,), "zeros")]
    if spec.ffn == "dense":
        out += _norm_shapes(cfg, "ffn_norm")
        if cfg.mlp_type == "gelu":
            out += [(("ffn", "w_in"), (D, F), D), (("ffn", "b_in"), (F,), "zeros"),
                    (("ffn", "w_out"), (F, D), F), (("ffn", "b_out"), (D,), "zeros")]
        else:
            out += [(("ffn", "w_gate"), (D, F), D), (("ffn", "w_up"), (D, F), D),
                    (("ffn", "w_down"), (F, D), F)]
    return out


def _norm_shapes(cfg: ModelConfig, name: str):
    """A norm's tensors: its scale, and for LayerNorm its bias (both
    float32, as the reference's ``init_norm``)."""
    out = [((name, "scale"), (cfg.d_model,), "ones")]
    if cfg.norm_type == "ln":
        out.append(((name, "bias"), (cfg.d_model,), "norm_bias"))
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
    D, Vp = cfg.d_model, cfg.padded_vocab
    params = {"embed": {"table": _normal(cfg, generator, dev, (Vp, D), D)},
              "blocks": [{f"l{i}": init_layer(cfg, spec, generator, dev)
                          for i, spec in enumerate(cfg.pattern)}
                         for _ in range(cfg.n_superblocks)],
              "final_norm": init_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(cfg, generator, dev, (Vp, D), Vp)}
    return params


def _normal(cfg: ModelConfig, generator, dev, shape, fan_in):
    """Normal with std 1/sqrt(fan_in), drawn in float32, in ``cfg.dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return w.mul_(1.0 / math.sqrt(max(1, fan_in))).to(getattr(torch,
                                                              cfg.dtype))


def init_norm(cfg: ModelConfig, dev) -> dict:
    """A norm's parameters: scale ones (and LayerNorm bias zeros), f32."""
    return {path[-1]: (torch.ones if init == "ones" else torch.zeros)(
        shape, dtype=torch.float32, device=dev)
        for path, shape, init in _norm_shapes(cfg, "norm")}


def init_layer(cfg: ModelConfig, spec: LayerSpec, generator, dev) -> dict:
    """One layer's random weights (the reference's names and inits)."""
    layer: dict = {}
    for path, shape, init in _layer_shapes(cfg, spec):
        if init in ("ones", "norm_bias"):  # norms stay float32
            t = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=dev)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=getattr(torch, cfg.dtype),
                            device=dev)
        else:
            t = _normal(cfg, generator, dev, shape, init)
        _put(layer, path, t)
    return layer


def params_from_jax(cfg: ModelConfig, np_tree: dict, device="cuda") -> dict:
    """The reference's ``lm.init_params`` tree (numpy arrays, superblocks
    stacked on a leading axis) as the port's parameters on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    params = {k: {n: _from_numpy(a, dev) for n, a in v.items()}
              for k, v in np_tree.items() if k != "blocks"}
    params["blocks"] = [_superblock(np_tree["blocks"], i, dev)
                        for i in range(cfg.n_superblocks)]
    return params


def encoder_params_from_jax(cfg: ModelConfig, np_tree: dict,
                            device="cuda") -> dict:
    """The reference's ``init_encoder_params`` tree (numpy arrays, the
    ``n_layers`` one-layer blocks stacked on a leading axis) as the port's
    encoder parameters on ``device``: ``params["blocks"]`` is a list of
    ``{"l0": layer}`` dicts."""
    _check_supported(cfg, encoder=True)
    dev = resolve_device(device)
    params = {k: {n: _from_numpy(a, dev) for n, a in v.items()}
              for k, v in np_tree.items() if k != "blocks"}
    params["blocks"] = [_superblock(np_tree["blocks"], i, dev)
                        for i in range(cfg.n_layers)]
    return params


def _from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.tensor(a, device=dev)


def _superblock(tree, i: int, dev: torch.device):
    """Superblock ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _superblock(v, i, dev) for k, v in tree.items()}
    return _from_numpy(np.asarray(tree)[i], dev)


def cache_from_jax(cfg: ModelConfig, np_tree: dict, device="cuda") -> list:
    """The reference's ``make_cache``/``prefill`` cache (numpy arrays,
    superblocks stacked on a leading axis) as the port's cache on
    ``device``: one ``{"l{i}": {"k", "v"}}`` dict per superblock."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [_superblock(np_tree, i, dev) for i in range(cfg.n_superblocks)]


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


def hidden_logits(cfg: ModelConfig, params, h):
    """Final norm and vocab product of h (..., D) -> (..., Vp) float32.

    As the reference's ``preferred_element_type=float32``: the products
    of the model-type values are summed and returned in float32.  On the
    card a bf16 table is multiplied as it is, into a float32 result; the
    table is never cast (2.1 GB at llama3.1-8b's width).  The CPU has no
    such product, so there the operands are cast.
    """
    h = L.apply_norm(cfg, params["final_norm"], h)
    table = _lm_table(cfg, params)
    h2 = h.reshape(-1, h.shape[-1])
    if h2.dtype == torch.float32 or h2.device.type == "cpu":
        out = h2.float() @ table.float().T
    else:
        out = torch.mm(h2, table.T, out_dtype=torch.float32)
    return out.reshape(*h.shape[:-1], table.shape[0])


def forward(cfg: ModelConfig, params, tokens):
    """Full-sequence forward -> (logits (B,S,Vp) float32, aux)."""
    h, aux = forward_hidden(cfg, params, tokens)
    return hidden_logits(cfg, params, h), aux


# --------------------------------------------------------------------------
# KV cache + decode
# --------------------------------------------------------------------------


def _ring_len(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.window is None:
        return max_len
    return min(spec.window, max_len)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, kv_dtype=None,
               device="cuda") -> list:
    """Zero-initialized decode cache: one ``{"l{i}": {"k", "v"}}`` dict per
    superblock, each (batch, ring_len, KV, hd)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    kv_dtype = kv_dtype or getattr(torch, cfg.dtype)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return [{f"l{i}": {kv: torch.zeros((batch, _ring_len(cfg, spec, max_len),
                                        KV, hd), dtype=kv_dtype, device=dev)
                       for kv in ("k", "v")}
             for i, spec in enumerate(cfg.pattern)}
            for _ in range(cfg.n_superblocks)]


def _apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p, c, h, pos):
    hn = L.apply_norm(cfg, p["norm"], h)
    out, _ = L.attention_decode(cfg, p["attn"], hn, c, pos,
                                window=spec.window)
    h = h + out
    if spec.ffn == "dense":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        h = h + L.apply_mlp(cfg, p["ffn"], hf)
    return h


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step.  tokens (B,) int; pos (B,) 0-based position.

    Returns (logits (B, Vp) float32, cache).  The cache is updated in
    place (the reference returns a new one): clone it first to keep the
    old contents.
    """
    _check_supported(cfg)
    h = params["embed"]["table"][tokens[:, None]]  # (B,1,D)
    for sb, sb_cache in zip(params["blocks"], cache):
        for i, spec in enumerate(cfg.pattern):
            h = _apply_layer_decode(cfg, spec, sb[f"l{i}"], sb_cache[f"l{i}"],
                                    h, pos)
    return hidden_logits(cfg, params, h[:, 0]), cache


# --------------------------------------------------------------------------
# prefill: full-sequence forward that also builds the decode cache
# --------------------------------------------------------------------------


def _project_kv_cache(cfg: ModelConfig, p, hn, positions, ring_len: int):
    """K/V for the whole sequence (post-RoPE), folded into a ring layout."""
    B, S, _ = hn.shape
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = hn @ p["wk"]
    v = hn @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.pos_type == "rope":
        k = L.apply_rope(k, positions, cfg.rope_theta)
    if ring_len >= S:
        pad = (0, 0, 0, 0, 0, ring_len - S)
        return F.pad(k, pad), F.pad(v, pad)
    # keep last ring_len positions at slot p % ring_len
    kl, vl = k[:, S - ring_len:], v[:, S - ring_len:]
    slots = torch.arange(S - ring_len, S, device=hn.device) % ring_len
    kc, vc = torch.zeros_like(kl), torch.zeros_like(vl)
    kc[:, slots] = kl
    vc[:, slots] = vl
    return kc, vc


def prefill_hidden(cfg: ModelConfig, params, tokens, max_len=None):
    """Forward over a prompt, building the decode cache.

    Returns (h (B,S,D) final hidden states before the final norm, cache,
    next_pos (B,)).  ``max_len`` (default S) sizes the global layers'
    cache.
    """
    _check_supported(cfg)
    h = params["embed"]["table"][tokens]
    B, S, _ = h.shape
    max_len = max_len or S
    positions = torch.arange(S, device=h.device)[None, :]
    cache = []
    for sb in params["blocks"]:
        sb_cache = {}
        for i, spec in enumerate(cfg.pattern):
            p = sb[f"l{i}"]
            hn = L.apply_norm(cfg, p["norm"], h)
            k, v = _project_kv_cache(cfg, p["attn"], hn, positions,
                                     _ring_len(cfg, spec, max_len))
            sb_cache[f"l{i}"] = {"k": k, "v": v}
            h = h + L.attention_apply(cfg, p["attn"], hn, causal=True,
                                      window=spec.window, positions=positions)
            if spec.ffn == "dense":
                hf = L.apply_norm(cfg, p["ffn_norm"], h)
                h = h + L.apply_mlp(cfg, p["ffn"], hf)
        cache.append(sb_cache)
    return h, cache, torch.full((B,), S, dtype=torch.long, device=h.device)


def prefill(cfg: ModelConfig, params, tokens, max_len=None,
            last_only: bool = False):
    """Forward over a prompt, building the decode cache.

    Returns (logits, cache, next_pos (B,)); logits are (B,S,Vp) float32,
    or (B,Vp) for the last position only when ``last_only``.
    """
    h, cache, next_pos = prefill_hidden(cfg, params, tokens, max_len)
    logits = hidden_logits(cfg, params, h[:, -1] if last_only else h)
    return logits, cache, next_pos
