"""Pareto-smoothed importance sampling (PSIS), counterpart of
``viabel_tpu/psis.py`` (Vehtari, Gelman & Gabry 2017, arXiv:1507.02646).

The algorithm is the JAX package's and its reference's:

- :func:`psislw`: max-stabilize, take as the tail the weights above the
  ``ceil(min(0.2 n, 3 sqrt(n / Reff)))``-th largest, fit a generalized
  Pareto distribution to the exceedances, replace the tail with the GPD's
  order-statistic quantiles when ``khat >= 1/3``, truncate at the largest
  raw weight and renormalize; ``khat = inf`` with fewer than 5 tail draws.
- :func:`gpdfitnew`: Zhang & Stephens (2009) empirical-Bayes fit on a
  ``30 + sqrt(n)``-point grid with the prior shrink
  ``k n / (n + 10) + 5 / (n + 10)``.

PyTorch runs eagerly, so the tail has its true length (boolean indexing,
as the reference does) where the JAX package slices a fixed top-``T``
block and masks it; the results are the same. Columns of a 2-D input are
smoothed one at a time.
"""

import math

import numpy as np
import torch

__all__ = ["psislw", "psisloo", "gpdfitnew", "gpinv", "sumlogs"]

_EPS = float(np.finfo(np.float64).eps)


def sumlogs(x, axis=None):
    """``log(sum(exp(x)))`` computed stably."""
    x = torch.as_tensor(x)
    if axis is None:
        return torch.logsumexp(x.reshape(-1), dim=0)
    return torch.logsumexp(x, dim=axis)


def gpinv(p, k, sigma):
    """Inverse generalized-Pareto CDF."""
    p = torch.as_tensor(p)
    k = torch.as_tensor(k, dtype=p.dtype, device=p.device)
    sigma = torch.as_tensor(sigma, dtype=p.dtype, device=p.device)
    ok = (p > 0) & (p < 1)
    lognp = torch.log1p(-torch.clamp(p, 1e-12, 1.0 - 1e-12))
    small_k = torch.abs(k) < _EPS
    x_big = torch.expm1(-k * lognp) / torch.where(small_k, torch.ones_like(k), k)
    x = torch.where(small_k, -lognp, x_big) * sigma
    x = torch.where(ok, x, torch.nan)
    x = torch.where(p == 0, 0.0, x)
    x = torch.where(p == 1, torch.where(k >= 0, torch.inf, -sigma / k), x)
    return torch.where(sigma <= 0, torch.nan, x)


def _gpdfit_sorted(x):
    """Zhang-Stephens fit of ascending exceedances ``x``; ``(k, sigma)``."""
    n = x.shape[0]
    m = 30 + math.isqrt(n)
    j = torch.arange(1, m + 1, dtype=x.dtype, device=x.device)
    x_quart = x[int(n / 4 + 0.5) - 1]
    bs = (1.0 - torch.sqrt(m / (j - 0.5))) / (3.0 * x_quart) + 1.0 / x[-1]
    ks = torch.mean(torch.log1p(-bs[:, None] * x[None, :]), dim=1)
    L = n * (torch.log(-bs / ks) - ks - 1.0)
    # w_j = 1 / sum_l exp(L_l - L_j)
    w = torch.exp(-torch.logsumexp(L[None, :] - L[:, None], dim=1))
    # prune negligible weights
    w = torch.where(w >= 10.0 * _EPS, w, 0.0)
    w = w / torch.sum(w)
    b = torch.sum(bs * w)
    k = torch.mean(torch.log1p(-b * x))
    sigma = -k / b
    a = 10.0  # weakly informative prior
    return k * n / (n + a) + a * 0.5 / (n + a), sigma


def gpdfitnew(x):
    """Empirical-Bayes GPD fit of 1-D positive exceedances (any order).
    Returns ``(k, sigma)``."""
    return _gpdfit_sorted(torch.sort(torch.as_tensor(x)).values)


def _psislw_1d(lw, n_tail, cutoffmin):
    """Smooth one vector of log weights; returns ``(smoothed_lw, khat)``."""
    n = lw.shape[0]
    x = lw - torch.max(lw)
    x_sorted = torch.sort(x).values
    xcutoff = torch.clamp(x_sorted[n - n_tail - 1], min=cutoffmin)
    tail_idx = torch.nonzero(x > xcutoff)[:, 0]
    n2 = tail_idx.shape[0]
    if n2 <= 4:
        return x - torch.logsumexp(x, dim=0), torch.tensor(
            math.inf, dtype=lw.dtype, device=lw.device)
    order = torch.argsort(x[tail_idx], stable=True)
    tail_idx = tail_idx[order]
    expcutoff = torch.exp(xcutoff)
    k, sigma = _gpdfit_sorted(torch.exp(x[tail_idx]) - expcutoff)
    if k >= 1.0 / 3.0:
        sti = (torch.arange(n2, dtype=lw.dtype, device=lw.device) + 0.5) / n2
        qq = gpinv(sti, k, sigma) + expcutoff
        x = x.clone()
        x[tail_idx] = torch.clamp(torch.log(qq), max=0.0)  # truncate at max raw weight
    return x - torch.logsumexp(x, dim=0), k


def psislw(lw, Reff=1.0):
    """Pareto-smoothed importance sampling.

    ``lw``: ``(n,)`` or ``(n, m)`` log weights. Returns ``(smoothed_lw,
    khat)`` with ``khat`` a scalar or ``(m,)``.
    """
    lw = torch.as_tensor(lw)
    if lw.dim() not in (1, 2):
        raise ValueError("Argument `lw` must be 1 or 2 dimensional.")
    n = lw.shape[0]
    if n <= 1:
        raise ValueError("More than one log-weight needed.")
    n_tail = int(np.ceil(min(0.2 * n, 3.0 * np.sqrt(n / Reff))))
    cutoffmin = float(np.log(np.finfo(np.float64).tiny))
    if lw.dim() == 1:
        return _psislw_1d(lw, n_tail, cutoffmin)
    cols = [_psislw_1d(lw[:, j], n_tail, cutoffmin) for j in range(lw.shape[1])]
    return (torch.stack([c[0] for c in cols], dim=1),
            torch.stack([c[1] for c in cols]))


def psisloo(log_lik, **kwargs):
    """PSIS leave-one-out log predictive densities.

    ``log_lik``: ``(n, m)`` posterior draws of log-likelihood terms.
    Returns ``(loo, loos, ks)``.
    """
    log_lik = torch.as_tensor(log_lik)
    lw, ks = psislw(-log_lik, **kwargs)
    loos = sumlogs(lw + log_lik, axis=0)
    return torch.sum(loos), loos, ks
