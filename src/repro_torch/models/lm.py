"""Decoder LM and encoder-decoder: forward, yes/no logit select, prefill
and decode over a KV cache, for every layer kind of the model zoo
(attention, Mamba, dense and MoE FFNs, cross-attention) with the VLM
prefix and sinusoidal positions.

Parameters are plain nested dicts of tensors with the reference's names.
The reference stacks the superblocks along a leading axis and scans over
them; here ``params["blocks"]`` (and an encoder-decoder's
``params["enc_blocks"]``) is a list with one dict per superblock and the
forward is a Python loop over layers.  The decode cache follows the same
layout: a list with one ``{"l{i}": entry}`` dict per superblock, where an
attention layer's entry holds ``"k"``/``"v"``, a Mamba layer's ``"h"``
(the float32 SSM state) and ``"conv"``, and an encoder-decoder's also the
static cross-attention ``"xk"``/``"xv"``.  ``init_layer`` and
``encoder_params_from_jax`` also serve the bidirectional embedding
encoder (``repro_torch.embeddings.encoder``).

Where autograd records (training), each superblock runs under
``cfg.remat_policy``, as the reference's ``_remat``: "full" recomputes
the superblock in the backward, "dots" keeps its matmul outputs and
recomputes the rest, "none" keeps everything.  Under ``no_grad`` and
``inference_mode`` (serving) nothing is wrapped.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed import partition
from repro_torch.distributed.api import shard_act, split_dim
from repro_torch.distributed.partition import by_rule
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.obs.trace import get_tracer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map_with_path_str

# the whisper-style encoder's one-layer superblock (the reference's)
_ENC_SPEC = LayerSpec(kind="attn", ffn="dense")


def _check_supported(cfg: ModelConfig, encoder: bool = False) -> None:
    """Keep the ``encoder`` family (the embedding encoder) and the decoder
    apart: an encoder config runs only where the encoder asks for it
    (``encoder=True``), and the decoder paths refuse it."""
    if encoder:
        if cfg.family != "encoder":
            raise ValueError(f"{cfg.name}: not an encoder config "
                             f"(family {cfg.family!r})")
        return
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.name}: an encoder config runs through "
                         "repro_torch.embeddings.encoder, not the decoder")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec,
                  with_xattn: bool = False):
    """(name path, shape, init, dtype) of one layer's tensors, in the
    reference's names.  ``init`` is "ones", "zeros", "a_log" (Mamba's
    log(1..ssm_state) on every row), "dt_bias" (-4.6, softplus^-1(0.01))
    or the fan-in of a normal weight; ``dtype`` is "model" (``cfg.dtype``)
    or "float32" (norms, the MoE router and Mamba's A_log, D and dt_bias,
    as the reference keeps them)."""
    D, hd, F_ = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    out = _norm_shapes(cfg, "norm")
    if spec.kind == "attn":
        out += _attn_shapes(cfg, "attn", cross=False)
    else:
        di, ds, dr, dc = (cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                          cfg.ssm_conv)
        m = "mamba"
        out += [((m, "in_proj"), (D, 2 * di), D, "model"),
                ((m, "conv_w"), (dc, di), dc, "model"),
                ((m, "conv_b"), (di,), "zeros", "model"),
                ((m, "x_proj"), (di, dr + 2 * ds), di, "model"),
                ((m, "dt_proj"), (dr, di), dr, "model"),
                ((m, "dt_bias"), (di,), "dt_bias", "float32"),
                ((m, "A_log"), (di, ds), "a_log", "float32"),
                ((m, "D"), (di,), "ones", "float32"),
                ((m, "out_proj"), (di, D), di, "model")]
    if with_xattn:
        out += _norm_shapes(cfg, "xattn_norm")
        out += _attn_shapes(cfg, "xattn", cross=True)
    if spec.ffn == "dense":
        out += _norm_shapes(cfg, "ffn_norm")
        if cfg.mlp_type == "gelu":
            out += [(("ffn", "w_in"), (D, F_), D, "model"),
                    (("ffn", "b_in"), (F_,), "zeros", "model"),
                    (("ffn", "w_out"), (F_, D), F_, "model"),
                    (("ffn", "b_out"), (D,), "zeros", "model")]
        else:
            out += [(("ffn", "w_gate"), (D, F_), D, "model"),
                    (("ffn", "w_up"), (D, F_), D, "model"),
                    (("ffn", "w_down"), (F_, D), F_, "model")]
    elif spec.ffn == "moe":
        E = cfg.n_experts
        out += _norm_shapes(cfg, "ffn_norm")
        out += [(("moe", "router"), (D, E), D, "float32"),
                (("moe", "w_gate"), (E, D, F_), D, "model"),
                (("moe", "w_up"), (E, D, F_), D, "model"),
                (("moe", "w_down"), (E, F_, D), F_, "model")]
    return out


def _attn_shapes(cfg: ModelConfig, name: str, cross: bool):
    """An attention block's tensors; a cross-attention block has no QKV
    bias, as the reference's ``init_attention(cross=True)``."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out = [((name, "wq"), (D, H * hd), D, "model"),
           ((name, "wk"), (D, KV * hd), D, "model"),
           ((name, "wv"), (D, KV * hd), D, "model"),
           ((name, "wo"), (H * hd, D), H * hd, "model")]
    if cfg.qkv_bias and not cross:
        out += [((name, "bq"), (H * hd,), "zeros", "model"),
                ((name, "bk"), (KV * hd,), "zeros", "model"),
                ((name, "bv"), (KV * hd,), "zeros", "model")]
    return out


def _norm_shapes(cfg: ModelConfig, name: str):
    """A norm's tensors: its scale, and for LayerNorm its bias (both
    float32, as the reference's ``init_norm``)."""
    out = [((name, "scale"), (cfg.d_model,), "ones", "float32")]
    if cfg.norm_type == "ln":
        out.append(((name, "bias"), (cfg.d_model,), "zeros", "float32"))
    return out


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights on ``device``, one tensor at a time.

    Normal weights have std 1/sqrt(fan_in) as in the reference; norm
    scales are ones, biases zeros, and Mamba's A_log, D and dt_bias take
    the reference's fixed values.  ``generator`` must live on ``device``
    (``torch.Generator(device="cuda")`` for the card).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    D, Vp = cfg.d_model, cfg.padded_vocab
    params = {"embed": {"table": _normal(cfg, generator, dev, (Vp, D), D)},
              "blocks": [{f"l{i}": init_layer(cfg, spec, generator, dev,
                                              with_xattn=cfg.is_encdec)
                          for i, spec in enumerate(cfg.pattern)}
                         for _ in range(cfg.n_superblocks)],
              "final_norm": init_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(cfg, generator, dev, (Vp, D), Vp)}
    if cfg.is_encdec:
        params["enc_blocks"] = [
            {"l0": init_layer(cfg, _ENC_SPEC, generator, dev)}
            for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = init_norm(cfg, dev)
    return params


def _normal(cfg: ModelConfig, generator, dev, shape, fan_in,
            dtype: str = "model"):
    """Normal with std 1/sqrt(fan_in), drawn in float32, in ``cfg.dtype``
    (or float32 for ``dtype="float32"``)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    w.mul_(1.0 / math.sqrt(max(1, fan_in)))
    return w if dtype == "float32" else w.to(getattr(torch, cfg.dtype))


def init_norm(cfg: ModelConfig, dev) -> dict:
    """A norm's parameters: scale ones (and LayerNorm bias zeros), f32."""
    return {path[-1]: (torch.ones if init == "ones" else torch.zeros)(
        shape, dtype=torch.float32, device=dev)
        for path, shape, init, _ in _norm_shapes(cfg, "norm")}


def init_layer(cfg: ModelConfig, spec: LayerSpec, generator, dev,
               with_xattn: bool = False) -> dict:
    """One layer's random weights (the reference's names, inits and
    dtypes); ``with_xattn`` adds an encoder-decoder's cross-attention."""
    layer: dict = {}
    for path, shape, init, dtype in _layer_shapes(cfg, spec, with_xattn):
        tdt = torch.float32 if dtype == "float32" else getattr(torch,
                                                              cfg.dtype)
        if init == "ones":
            t = torch.ones(shape, dtype=tdt, device=dev)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=tdt, device=dev)
        elif init == "dt_bias":
            t = torch.full(shape, -4.6, dtype=tdt, device=dev)
        elif init == "a_log":
            t = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float64,
                                       device=dev)).to(tdt).expand(shape)
            t = t.clone()
        else:
            t = _normal(cfg, generator, dev, shape, init, dtype)
        _put(layer, path, t)
    return layer


def params_from_jax(cfg: ModelConfig, np_tree: dict, device="cuda") -> dict:
    """The reference's ``lm.init_params`` tree (numpy arrays, superblocks
    stacked on a leading axis) as the port's parameters on ``device``;
    an encoder-decoder's ``enc_blocks`` are unstacked the same way."""
    _check_supported(cfg)
    dev = resolve_device(device)
    stacked = {"blocks": cfg.n_superblocks, "enc_blocks": cfg.encoder_layers}
    return {k: ([_superblock(v, i, dev) for i in range(stacked[k])]
                if k in stacked else
                {n: _from_numpy(a, dev) for n, a in v.items()})
            for k, v in np_tree.items()}


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


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes, no storage):
    the dry run's stand-in, as the reference's ``eval_shape`` tree."""
    return init_params(cfg, None, device="meta")


_SUFFIX_AXES = {
    ("embed", "table"): ("vocab", "embed"),
    ("lm_head", "w"): ("vocab", "embed"),
    ("attn", "wq"): ("embed", "heads"),
    ("attn", "wk"): ("embed", "kv_heads"),
    ("attn", "wv"): ("embed", "kv_heads"),
    ("attn", "wo"): ("heads", "embed"),
    ("attn", "bq"): ("heads",),
    ("attn", "bk"): ("kv_heads",),
    ("attn", "bv"): ("kv_heads",),
    ("xattn", "wq"): ("embed", "heads"),
    ("xattn", "wk"): ("embed", "kv_heads"),
    ("xattn", "wv"): ("embed", "kv_heads"),
    ("xattn", "wo"): ("heads", "embed"),
    ("ffn", "w_gate"): ("embed", "ffn"),
    ("ffn", "w_up"): ("embed", "ffn"),
    ("ffn", "w_down"): ("ffn", "embed"),
    ("ffn", "w_in"): ("embed", "ffn"),
    ("ffn", "w_out"): ("ffn", "embed"),
    ("ffn", "b_in"): ("ffn",),
    ("ffn", "b_out"): (None,),
    ("moe", "router"): ("embed", None),
    ("moe", "w_gate"): ("experts", "embed", "ffn"),
    ("moe", "w_up"): ("experts", "embed", "ffn"),
    ("moe", "w_down"): ("experts", "ffn", "embed"),
    ("mamba", "in_proj"): ("embed", "inner"),
    ("mamba", "conv_w"): (None, "inner"),
    ("mamba", "conv_b"): ("inner",),
    ("mamba", "x_proj"): ("inner", None),
    ("mamba", "dt_proj"): (None, "inner"),
    ("mamba", "dt_bias"): ("inner",),
    ("mamba", "A_log"): ("inner", None),
    ("mamba", "D"): ("inner",),
    ("mamba", "out_proj"): ("inner", "embed"),
}


def param_logical_axes(cfg: ModelConfig) -> dict:
    """Tree of logical-axis tuples matching ``init_params``'s structure.

    The reference's names; a superblock's leaves have no stacked axis
    here, so each tuple is the reference's without its leading None.
    Norms and other unnamed leaves are replicated (all None)."""

    def assign(path: str, leaf):
        axes = _SUFFIX_AXES.get(tuple(path.split("/")[-2:]))
        if axes is None:
            axes = (None,) * leaf.ndim
        if len(axes) != leaf.ndim:
            raise ValueError(f"{path}: axes {axes} for shape "
                             f"{tuple(leaf.shape)}")
        return tuple(axes)

    return tree_map_with_path_str(assign, abstract_params(cfg))


def cache_from_jax(cfg: ModelConfig, np_tree: dict, device="cuda") -> list:
    """The reference's ``make_cache``/``prefill`` cache (numpy arrays,
    superblocks stacked on a leading axis) as the port's cache on
    ``device``: one ``{"l{i}": entry}`` dict per superblock."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [_superblock(np_tree, i, dev) for i in range(cfg.n_superblocks)]


# --------------------------------------------------------------------------
# forward (full sequence)
# --------------------------------------------------------------------------


@by_rule(partition.embed)
def _embed(table, tokens):
    """``table[tokens]``."""
    return table[tokens]


def _inputs(cfg: ModelConfig, params, tokens, prefix_embeds, enc_frames):
    """The stack's input: token embeddings after the VLM prefix (cast to
    the model type), sinusoidal positions where the config has them; the
    positions (1, S); and an encoder-decoder's encoder output."""
    h = _embed(params["embed"]["table"], tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    if cfg.pos_type == "sinusoidal":
        h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    enc_out = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder takes "
                             "enc_frames (B, Senc, D)")
        enc_out = encode(cfg, params, enc_frames)
    return h, positions, enc_out


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p, h, positions,
                 enc_out=None, entry=None, max_len=None, index=None):
    """One layer, full-sequence mode -> (h, aux): aux is the MoE FFN's
    load-balance loss, None for other layers.  With ``entry`` (prefill)
    the layer's decode cache goes into that dict: post-RoPE K/V folded to
    the ring (``max_len`` for a global layer), Mamba's final state and
    conv window, and an encoder-decoder's static cross-attention K/V.
    The mixer and the FFN each run in a span of kind "layer" named by
    their kind (``attn``, ``mamba``, ``mlp``, ``moe``), with ``index``,
    the layer's place in its superblock, as its ``layer``; norms and
    residual adds stay outside them."""
    tr = get_tracer()
    aux = None
    hn = L.apply_norm(cfg, p["norm"], h)
    if spec.kind == "attn":
        with tr.span("attn", kind="layer", layer=index):
            if entry is not None:
                entry["k"], entry["v"] = _project_kv_cache(
                    cfg, p["attn"], hn, positions,
                    _ring_len(cfg, spec, max_len))
            out = L.attention_apply(cfg, p["attn"], hn, causal=True,
                                    window=spec.window, positions=positions)
    else:
        with tr.span("mamba", kind="layer", layer=index):
            out, (state, conv) = L.mamba_scan(cfg, p["mamba"], hn)
        if entry is not None:
            entry["h"], entry["conv"] = state, conv
    h = _residual(h, out)
    if "xattn" in p and enc_out is not None:
        hx = L.apply_norm(cfg, p["xattn_norm"], h)
        h = _residual(h, L.attention_plain(cfg, p["xattn"], hx,
                                           causal=False, kv_x=enc_out))
        if entry is not None:
            heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
            entry["xk"] = split_dim(enc_out @ p["xattn"]["wk"], -1, heads)
            entry["xv"] = split_dim(enc_out @ p["xattn"]["wv"], -1, heads)
    if spec.ffn == "dense":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        with tr.span("mlp", kind="layer", layer=index):
            out = L.apply_mlp(cfg, p["ffn"], hf)
        h = _residual(h, out)
    elif spec.ffn == "moe":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        with tr.span("moe", kind="layer", layer=index):
            out, aux = L.apply_moe(cfg, p["moe"], hf)
        h = _residual(h, out)
    return h, aux


def _residual(h, out):
    """``h + out``, the block's output first constrained as the residual
    stream is, to its batch shards and whole along the sequence and the
    width: partitioned, a block's output (a Partial sum where its last
    product contracts a split dim) is reduced here, as Megatron's
    row-parallel products are, before it meets the stream.  Left to
    DTensor, the sum of a replicated stream and a Partial output is
    planned as a Partial stream, whose gradient then reaches the block
    split along its rows, so the block's backward gathers its weights
    whole and every model rank repeats the whole product (twice the
    FLOPs a device of gemma3-12b x train_4k, PERF.md §6); and the stream
    would be split along the sequence, which DTensor cannot plan cheaply
    once the batch is split over two mesh axes.  The reference
    constrains the stream once, at the stack's input; these constraints
    after every block are the port's own (their cost on the pod mesh:
    ``scripts/compare_dryrun_collectives.py --residual``).  The sum is
    constrained too: its gradient, so placed, reaches the block whole
    along the rows."""
    return shard_act(h + shard_act(out, ("batch", None, None)),
                     ("batch", None, None))


def _superblock_fwd(cfg: ModelConfig, sb, h, positions, enc_out,
                    sb_cache=None, max_len=None):
    """One superblock's layers -> (h, aux); with ``sb_cache`` (prefill)
    each layer's decode cache goes into ``sb_cache["l{i}"]``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, spec in enumerate(cfg.pattern):
        entry = None if sb_cache is None else sb_cache.setdefault(f"l{i}", {})
        h, a = _apply_layer(cfg, spec, sb[f"l{i}"], h, positions, enc_out,
                            entry, max_len, i)
        if a is not None:
            aux = aux + a
    return h, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matmuls without batch
    dimensions (the reference's ``dots_with_no_batch_dims_saveable``:
    projections, FFNs, experts' products flattened to ``mm``), recompute
    everything else, the attention's batched products included."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, p, fn, *args):
    """fn(*args) under ``cfg.remat_policy`` when autograd records through
    it (grad mode on, and an argument or a leaf of its parameters ``p``
    requires grad), as the reference's ``_remat`` wraps each superblock;
    a plain call otherwise."""
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tree_leaves(p), *args)
        if isinstance(t, torch.Tensor))
    if cfg.remat_policy == "none" or not records:
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=partial(
            create_selective_checkpoint_contexts, _save_matmuls))
    return checkpoint(fn, *args, use_reentrant=False)


def _run_stack(cfg: ModelConfig, params, h, positions, enc_out,
               max_len=None):
    """Every superblock in turn -> (h, aux, cache).  The aux adds up by
    superblock as the reference's scan carries it; ``cache`` is built
    only when ``max_len`` is given (prefill), else None.  Without a
    cache each superblock runs under ``_remat``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = None if max_len is None else []
    for sb in params["blocks"]:
        if cache is None:
            h, sb_aux = _remat(cfg, sb, partial(_superblock_fwd, cfg, sb),
                               h, positions, enc_out)
        else:
            cache.append({})
            h, sb_aux = _superblock_fwd(cfg, sb, h, positions, enc_out,
                                        cache[-1], max_len)
        aux = aux + sb_aux
    return h, aux, cache


def _lm_table(cfg: ModelConfig, params):
    return (params["lm_head"]["w"] if not cfg.tie_embeddings
            else params["embed"]["table"])


def encode(cfg: ModelConfig, params, enc_frames):
    """Whisper-style encoder over stub frame embeddings (B, Senc, D), cast
    to the model type: sinusoidal positions, bidirectional attention
    without RoPE, dense FFNs, a final norm."""
    h = enc_frames.to(params["embed"]["table"].dtype)
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    h = h + L.sinusoidal_positions(pos, cfg.d_model).to(h.dtype)
    for blk in params["enc_blocks"]:
        h = _remat(cfg, blk, partial(_encoder_layer, cfg, blk["l0"]), h)
    return L.apply_norm(cfg, params["enc_final_norm"], h)


def _encoder_layer(cfg: ModelConfig, p, h):
    hn = L.apply_norm(cfg, p["norm"], h)
    h = _residual(h, L.attention_plain(cfg, p["attn"], hn, causal=False,
                                       rope=False))
    hf = L.apply_norm(cfg, p["ffn_norm"], h)
    return _residual(h, L.apply_mlp(cfg, p["ffn"], hf))


def forward_hidden(cfg: ModelConfig, params, tokens, prefix_embeds=None,
                   enc_frames=None):
    """Full-sequence forward up to the final hidden states -> (h, aux):
    aux is the sum of the MoE layers' load-balance losses (0 without
    MoE)."""
    _check_supported(cfg)
    h, positions, enc_out = _inputs(cfg, params, tokens, prefix_embeds,
                                    enc_frames)
    h = shard_act(h, ("batch", None, None))
    h, aux, _ = _run_stack(cfg, params, h, positions, enc_out)
    return h, aux


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
        out = _matmul_f32(h2, table)
    out = out.reshape(*h.shape[:-1], table.shape[0])
    return shard_act(out, ("batch", None, "vocab")) if out.ndim == 3 else out


class _MatmulF32(torch.autograd.Function):
    """h (N, D) @ table (V, D).T in the model type into a float32 result.

    ``torch.mm(..., out_dtype=)`` has no derivative, so the backward is
    written here: the float32 cotangent is rounded to the model type
    for its two products (each into the model type, as the reference
    casts the cotangents back), as the TPU's default-precision dot takes
    the reference's float32 cotangent through bf16 passes.  A float32
    table (622 MB at qwen1.5-0.5b's width) is never made."""

    @staticmethod
    def forward(ctx, h2, table):
        ctx.save_for_backward(h2, table)
        return torch.mm(h2, table.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h2, table = ctx.saved_tensors
        g = g.to(h2.dtype)
        return (g @ table if ctx.needs_input_grad[0] else None,
                g.T @ h2 if ctx.needs_input_grad[1] else None)


@by_rule(partition.matmul_f32)
def _matmul_f32(h2, table):
    return _MatmulF32.apply(h2, table)


def forward(cfg: ModelConfig, params, tokens, prefix_embeds=None,
            enc_frames=None):
    """Full-sequence forward -> (logits (B,S,Vp) float32, aux).

    - ``prefix_embeds`` (B, P, D): VLM stub — prepended to token
      embeddings; total sequence length = P + tokens.shape[1].
    - ``enc_frames`` (B, Senc, D): audio stub for enc-dec models.
    """
    h, aux = forward_hidden(cfg, params, tokens, prefix_embeds, enc_frames)
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
    """Zero-initialized decode cache: one ``{"l{i}": entry}`` dict per
    superblock.  An attention layer's entry holds "k"/"v" (batch,
    ring_len, KV, hd); a Mamba layer's "h" (batch, d_inner, ssm_state)
    float32 and "conv" (batch, ssm_conv - 1, d_inner); an
    encoder-decoder's layers also "xk"/"xv" (batch, encoder_len, KV, hd).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    kv_dtype = kv_dtype or getattr(torch, cfg.dtype)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def entry(spec):
        if spec.kind == "attn":
            shape = (batch, _ring_len(cfg, spec, max_len), KV, hd)
            e = {kv: torch.zeros(shape, dtype=kv_dtype, device=dev)
                 for kv in ("k", "v")}
        else:
            e = {"h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                                  dtype=torch.float32, device=dev),
                 "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                     dtype=kv_dtype, device=dev)}
        if cfg.is_encdec:
            for kv in ("xk", "xv"):
                e[kv] = torch.zeros((batch, cfg.encoder_len, KV, hd),
                                    dtype=kv_dtype, device=dev)
        return e

    return [{f"l{i}": entry(spec) for i, spec in enumerate(cfg.pattern)}
            for _ in range(cfg.n_superblocks)]


def cache_logical_axes(cfg: ModelConfig, long_context: bool = False) -> list:
    """Logical axes tree matching ``make_cache``'s structure (one dict a
    superblock; the reference's tuples without their stacked axis)."""
    seq_axis = "kv_seq_long" if long_context else "kv_seq"

    def entry(spec):
        if spec.kind == "attn":
            e = {kv: ("kv_batch", seq_axis, "kv_heads", None)
                 for kv in ("k", "v")}
        else:
            e = {"h": ("kv_batch", "inner", None),
                 "conv": ("kv_batch", None, "inner")}
        if cfg.is_encdec:
            for kv in ("xk", "xv"):
                e[kv] = ("kv_batch", None, "kv_heads", None)
        return e

    return [{f"l{i}": entry(spec) for i, spec in enumerate(cfg.pattern)}
            for _ in range(cfg.n_superblocks)]


def _apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p, c, h, pos):
    """One layer of a decode step; the layer's cache entry ``c`` is updated
    in place (K/V rows written, the Mamba state and window replaced)."""
    hn = L.apply_norm(cfg, p["norm"], h)
    if spec.kind == "attn":
        out, _ = L.attention_decode(cfg, p["attn"], hn, c, pos,
                                    window=spec.window)
    else:
        out, state = L.mamba_decode(cfg, p["mamba"], hn, c)
        c.update(state)
    h = _residual(h, out)
    if "xattn" in p and "xk" in c:
        hx = L.apply_norm(cfg, p["xattn_norm"], h)
        out, _ = L.attention_decode(cfg, p["xattn"], hx, None, pos,
                                    cross_kv={"k": c["xk"], "v": c["xv"]})
        h = _residual(h, out)
    if spec.ffn == "dense":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        h = _residual(h, L.apply_mlp(cfg, p["ffn"], hf))
    elif spec.ffn == "moe":
        hf = L.apply_norm(cfg, p["ffn_norm"], h)
        out, _ = L.apply_moe(cfg, p["moe"], hf)
        h = _residual(h, out)
    return h


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step.  tokens (B,) int; pos (B,) 0-based position.

    Returns (logits (B, Vp) float32, cache).  The cache is updated in
    place (the reference returns a new one): clone it first to keep the
    old contents.
    """
    _check_supported(cfg)
    h = _embed(params["embed"]["table"], tokens[:, None])  # (B,1,D)
    if cfg.pos_type == "sinusoidal":
        h = h + L.sinusoidal_positions(pos[:, None], cfg.d_model).to(h.dtype)
    h = shard_act(h, ("batch", None, None))
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
    k = split_dim(k, -1, (KV, hd))
    v = split_dim(v, -1, (KV, hd))
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


def prefill_hidden(cfg: ModelConfig, params, tokens, prefix_embeds=None,
                   enc_frames=None, max_len=None):
    """Forward over a prompt, building the decode cache.

    Returns (h (B,S,D) final hidden states before the final norm, cache,
    next_pos (B,)); S counts the prefix.  ``max_len`` (default S) sizes
    the global layers' cache.  A Mamba layer's state is the scan's over
    all S positions, right padding included (the reference's).
    """
    _check_supported(cfg)
    h, positions, enc_out = _inputs(cfg, params, tokens, prefix_embeds,
                                    enc_frames)
    B, S, _ = h.shape
    # as forward_hidden: partitioned, the embedding's Partial sum is
    # reduced here, not carried into the first layer's products
    h = shard_act(h, ("batch", None, None))
    h, _, cache = _run_stack(cfg, params, h, positions, enc_out,
                             max_len=max_len or S)
    return h, cache, torch.full((B,), S, dtype=torch.long, device=h.device)


def prefill(cfg: ModelConfig, params, tokens, prefix_embeds=None,
            enc_frames=None, max_len=None, last_only: bool = False):
    """Forward over a prompt, building the decode cache.

    Returns (logits, cache, next_pos (B,)); logits are (B,S,Vp) float32,
    or (B,Vp) for the last position only when ``last_only``.
    """
    h, cache, next_pos = prefill_hidden(cfg, params, tokens, prefix_embeds,
                                        enc_frames, max_len)
    logits = hidden_logits(cfg, params, h[:, -1] if last_only else h)
    return logits, cache, next_pos
