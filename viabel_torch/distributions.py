"""Standalone density helpers (counterpart of ``viabel_tpu/distributions.py``).

Positive-definite scale matrices are whitened by a Cholesky factor and one
triangular solve, through :func:`viabel_torch.families._tri_solve`: a CUDA
input with ``d <= KERNEL_MAX_DIM`` reaches the triangular-solve kernel.
``allow_singular`` takes the eigendecomposition pseudo-inverse instead.
"""

import math

import torch

from .families import _tri_solve
from .utils import ensure_2d

__all__ = ["multivariate_t_logpdf", "multivariate_normal_logpdf"]

_LOG_2PI = math.log(2.0 * math.pi)


def multivariate_normal_logpdf(x, mean, cov):
    """Multivariate normal log pdf via Cholesky whitening; ``(n,)`` for
    ``x`` of shape ``(n, d)`` or ``(d,)``."""
    x = ensure_2d(x)
    d = mean.shape[-1]
    L = torch.linalg.cholesky(cov)
    y = _tri_solve(L, (x - mean).T, lower=True)
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * (torch.sum(y**2, dim=0) + log_det + d * _LOG_2PI)


def multivariate_t_logpdf(x, m, S, df=math.inf, allow_singular=False):
    """Multivariate Student-t log pdf.

    Parameters
    ----------
    x : (n, d) or (d,) evaluation points
    m : (d,) location
    S : (d, d) scale matrix
    df : degrees of freedom; ``inf`` gives the multivariate normal
    allow_singular : bool
        Use an eigendecomposition pseudo-inverse instead of Cholesky;
        needed only for a rank-deficient ``S``.
    """
    x = ensure_2d(x)
    d = m.shape[-1]
    df = float(df)
    if math.isinf(df):
        return multivariate_normal_logpdf(x, m, S)
    dev = x - m
    if allow_singular:
        s, u = torch.linalg.eigh(S)
        eps = 1e-10
        s_pinv = torch.where(torch.abs(s) <= eps, torch.zeros_like(s), 1.0 / s)
        U = u * torch.sqrt(s_pinv)
        maha = torch.sum((dev @ U) ** 2, dim=-1)
        log_pdet = torch.sum(torch.log(torch.where(s > eps, s, torch.ones_like(s))))
    else:
        L = torch.linalg.cholesky(S)
        y = _tri_solve(L, dev.T, lower=True)
        maha = torch.sum(y**2, dim=0)
        log_pdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return (math.lgamma(0.5 * (df + d)) - math.lgamma(0.5 * df)
            - 0.5 * d * math.log(math.pi * df) - 0.5 * log_pdet
            - 0.5 * (df + d) * torch.log1p(maha / df))
