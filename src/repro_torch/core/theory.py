"""Theoretical analysis (paper §3.2): Bernstein sampling-without-replacement
bounds connecting the sample ratio ξ to the user error tolerance ε.

All formulas follow the paper exactly:

Lemma 3.2 (Bernstein): Pr[|mu_hat - mu| >= eps]
    <= 2 exp( -k eps^2 / (2 sigma_hat^2 + 2 R eps / 3) * (n-k)/(n-1) )

Theorem 3.3 (UniVote): vote errs with prob <= max(lb+eps, 1-(ub-eps)) w.p.
    >= 1 - 2 l^n, provided
    xi >= 1/2 - sqrt(1/4 + ln(l) (2 sigma^2/eps^2 + 2/(3 eps)))

Theorem 3.6 (SimVote): same guarantee with
    xi >= 1/2 - sqrt(1/4 + v ln(l) (6 sigma^2 + 2 eps) / (3 eps^2))
"""
from __future__ import annotations

import math


def bernstein_tail(k: float, n: float, eps: float, sigma2: float,
                   R: float = 1.0) -> float:
    """Lemma 3.2 tail probability for k of n samples without replacement."""
    if k <= 0 or n <= 1:
        return 1.0
    fpc = (n - k) / (n - 1)  # finite population correction
    expo = -k * eps * eps / (2 * sigma2 + 2 * R * eps / 3) * fpc
    return min(1.0, 2 * math.exp(expo))


def xi_for_epsilon_univote(eps: float, sigma2: float, l: float = 0.9996) -> float:
    """Theorem 3.3 minimum sample ratio for tolerance eps (UniVote).

    l in (0,1): per-tuple failure scale (failure prob <= 2 l^n).  ln(l) < 0,
    so the sqrt argument is < 1/4 and xi lands in (0, 1/2].
    """
    assert 0 < l < 1 and eps > 0
    inner = 0.25 + math.log(l) * (2 * sigma2 / (eps * eps) + 2 / (3 * eps))
    if inner <= 0:
        return 1.0  # tolerance unreachable by sampling; fall back to full scan
    return max(0.0, 0.5 - math.sqrt(inner))


def xi_for_epsilon_simvote(eps: float, sigma2: float, l: float = 0.9996,
                           v: float = 2.0) -> float:
    """Theorem 3.6 minimum sample ratio (SimVote); v bounds max_i w_i <= v/k."""
    assert 0 < l < 1 and eps > 0 and v >= 1.0
    inner = 0.25 + v * math.log(l) * (6 * sigma2 + 2 * eps) / (3 * eps * eps)
    if inner <= 0:
        return 1.0
    return max(0.0, 0.5 - math.sqrt(inner))


def epsilon_for_xi(xi: float, n: int, sigma2: float, l: float = 0.9996,
                   weighted: bool = False, v: float = 2.0) -> float:
    """Inverse: the tolerance eps achieved by sample ratio xi on a size-n
    cluster (tightest eps with tail <= 2 l^n).  Solves the quadratic in eps.
    """
    k = max(1.0, xi * n)
    if k >= n:
        return 0.0
    target = -n * math.log(l)  # want k eps^2 fpc / (2 s + 2 eps/3) >= target
    fpc = (n - k) / (n - 1)
    if weighted:
        # k eps^2 fpc * 3 / (v (6 s^2 + 2 eps)) = target
        a = 3 * k * fpc
        b = -2 * v * target
        c = -6 * sigma2 * v * target
    else:
        a = k * fpc
        b = -2 * target / 3
        c = -2 * sigma2 * target
    disc = b * b - 4 * a * c
    return (-b + math.sqrt(max(0.0, disc))) / (2 * a)


def vote_error_bound(lb: float, ub: float, eps: float) -> float:
    """Theorem 3.3/3.6 final per-tuple error bound when the vote commits."""
    return max(lb + eps, 1 - (ub - eps))


def choose_sample_size(n: int, xi: float, min_sample: int = 101) -> int:
    """Paper §4.1: per-cluster sample count = max(ceil(xi*n), min_sample), <= n."""
    return min(n, max(min_sample, math.ceil(xi * n)))
