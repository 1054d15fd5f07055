"""Gradient compression for the cross-data-axis reduction.

Two schemes, both with *error feedback* (the compression residual is
folded into the next step: compress(g + e), and the new residual is
returned alongside):

- int8: per-tensor symmetric quantization (scale = max|g|/127), which
  shrinks an all-reduce payload 4x against float32.
- topk: keep the largest-|g| fraction per tensor (default 10%), zero
  the rest.

On one card there is no reduction to shrink; what these functions keep
is the algorithm (the rounding, the kept entries, convergence under
error feedback), equal to the reference's on the same gradients.  On
DTensor gradients they compress the global gradient, as the
reference's do under GSPMD: a Partial is reduced first.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import partition
from repro_torch.distributed.partition import by_rule
from repro_torch.utils.tree import tree_map


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """g quantized to int8 with a per-tensor scale and back, float32;
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    a = torch.max(torch.abs(g))
    scale = torch.clamp(a, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


@by_rule(partition.topk_threshold)
def _topk_threshold(g: torch.Tensor, frac: float) -> torch.Tensor:
    """The k-th largest |g| (k = frac of the entries, at least 1)."""
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.shape[0] * frac))
    return torch.topk(flat, k).values[-1]


def _topk_mask(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    """g with every entry below the k-th largest |g| zeroed (k = frac of
    the entries, at least 1).  Entries tied with the threshold are all
    kept, as the reference's ``>=``."""
    thresh = _topk_threshold(g, frac)
    return torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))


def _method(method: str, topk_frac: float):
    if method == "int8":
        return _int8_roundtrip
    return lambda g: _topk_mask(g, topk_frac)


def _map_pairs(fn, n_out, *trees):
    """n_out trees: tree_map of fn, which returns an n_out-tuple."""
    outs = tree_map(fn, *trees)
    is_out = lambda x: isinstance(x, tuple) and len(x) == n_out and all(
        isinstance(e, torch.Tensor) for e in x)
    return [tree_map(lambda o: o[i], outs, is_leaf=is_out)
            for i in range(n_out)]


def _map_stacked(fn, n_out, *trees):
    """``_map_pairs`` with each list of superblocks (``"blocks"``,
    ``"enc_blocks"``) stacked leaf by leaf first.  The reference keeps a
    superblock leaf as one array stacked over the superblocks and
    compresses it whole: one int8 scale, one top-k threshold for all
    superblocks."""
    head = trees[0]
    outs = [{} for _ in range(n_out)]
    for k in head:
        sub = [t[k] for t in trees]
        if isinstance(head[k], list):
            stacked = [tree_map(lambda *xs: torch.stack(xs), *t) for t in sub]
            for o, r in zip(outs, _map_pairs(fn, n_out, *stacked)):
                o[k] = [tree_map(lambda x: x[i], r)
                        for i in range(len(head[k]))]
        else:
            for o, r in zip(outs, _map_pairs(fn, n_out, *sub)):
                o[k] = r
    return outs


def compress_grads(grads, method: str = "int8", topk_frac: float = 0.1):
    """Stateless (per-step) compression round-trip; see
    compress_with_feedback for the error-feedback variant."""
    f = _method(method, topk_frac)
    return _map_stacked(lambda g: (f(g.to(torch.float32)).to(g.dtype),), 1,
                        grads)[0]


def compress_with_feedback(grads, residuals, method: str = "int8",
                           topk_frac: float = 0.1):
    """Error-feedback compression: compress(g + e); e' = (g + e) -
    compressed.  Returns (compressed_grads, new_residuals)."""
    f = _method(method, topk_frac)

    def one(g, e):
        x = g.to(torch.float32) + e
        c = f(x)
        return c.to(g.dtype), x - c

    return tuple(_map_stacked(one, 2, grads, residuals))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
