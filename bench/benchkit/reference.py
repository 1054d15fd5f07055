"""What every architecture's plain reference shares (``bench/archs``):
the precision of its products and the MoE routing it is given.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale a tensor (its largest magnitude at 448), sums
in float32.  Weights are read as given (the served bfloat16 tensors) and
widened one layer, or one expert, at a time.  A ``Route`` hands a
reference's MoE layers the experts that the program's router chose.
"""
from __future__ import annotations

import torch


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
