"""The front door's answers from log weights: PSIS, the 2-divergence and
the error bounds.

PSIS (Vehtari, Gelman & Gabry, arXiv:1507.02646): the tail is the
weights above the ``ceil(min(0.2 n, 3 sqrt(n)))``-th largest; a
generalized Pareto fit by Zhang & Stephens (2009) on a ``30 + sqrt(m)``
grid with the prior shrink ``k m / (m + 10) + 5 / (m + 10)``; when
``khat >= 1/3`` the tail is replaced by the fit's order-statistic
quantiles, truncated at the largest raw weight; the smoothed log
weights are normalized. khat above 0.7 (or not finite) sends the front
door to the KSD test instead of the bounds.

Bounds (Huggins et al., AISTATS 2020) from the smoothed log weights:
``d2 = 2 (CUBO - ELBO)``, ``W_p = 2 C_{2p}^{1/2p} expm1(d2)^{1/2p}`` with
q's central moments ``C``, mean error ``min(W1, W2)``, standard-deviation
error ``W2`` and covariance error ``2 (sqrt(||Sigma_q||_2) W2 + W2^2)``.
NumPy here, in the dtype of the log weights given.
"""

import math

import numpy as np

KHAT_GATE = 0.7


def _logsumexp(x):
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))


def gpd_fit(x):
    """Zhang-Stephens fit of ascending exceedances ``x``: ``(k, sigma)``."""
    n = x.shape[0]
    m = 30 + math.isqrt(n)
    j = np.arange(1, m + 1, dtype=x.dtype)
    x_quart = x[int(n / 4 + 0.5) - 1]
    bs = (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * x_quart) + 1.0 / x[-1]
    ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    L = n * (np.log(-bs / ks) - ks - 1.0)
    w = np.array([1.0 / np.sum(np.exp(L - L[i])) for i in range(m)], dtype=x.dtype)
    w = np.where(w >= 10.0 * np.finfo(np.float64).eps, w, 0.0)
    w = w / np.sum(w)
    b = np.sum(bs * w)
    k = np.mean(np.log1p(-b * x))
    sigma = -k / b
    return k * n / (n + 10.0) + 10.0 * 0.5 / (n + 10.0), sigma


def psis(log_weights):
    """``(smoothed normalized log weights, khat)`` of a 1-D array."""
    lw = np.asarray(log_weights)
    n = lw.shape[0]
    n_tail = int(np.ceil(min(0.2 * n, 3.0 * np.sqrt(n))))
    x = lw - np.max(lw)
    cutoff = max(np.sort(x)[n - n_tail - 1], np.log(np.finfo(np.float64).tiny))
    tail = np.flatnonzero(x > cutoff)
    if tail.shape[0] <= 4:
        return x - _logsumexp(x), math.inf
    tail = tail[np.argsort(x[tail], kind="stable")]
    exp_cutoff = np.exp(cutoff)
    k, sigma = gpd_fit(np.exp(x[tail]) - exp_cutoff)
    if k >= 1.0 / 3.0:
        p = (np.arange(tail.shape[0], dtype=x.dtype) + 0.5) / tail.shape[0]
        q = np.expm1(-k * np.log1p(-p)) / k * sigma + exp_cutoff
        x = x.copy()
        x[tail] = np.minimum(np.log(q), 0.0)
    return x - _logsumexp(x), float(k)


def answers(log_weights, moments):
    """The front door's answers: khat and its branch, and on the bounds
    branch d2 and the bounds. ``moments``: q's ``(E||X - EX||^2,
    E||X - EX||^4, ||Sigma_q||_2)``."""
    smoothed, khat = psis(log_weights)
    out = {"khat": khat}
    if not math.isfinite(khat) or khat > KHAT_GATE:
        out["branch"] = "ksd"
        return out
    out["branch"] = "bounds"
    top = np.max(smoothed)
    cubo = math.log(float(np.mean(np.exp(smoothed - top) ** 2))) / 2.0 + float(top)
    d2 = 2.0 * (cubo - float(np.mean(smoothed)))
    c2, c4, spec = (float(v) for v in moments)
    W1 = 2.0 * c2 ** 0.5 * math.expm1(d2) ** 0.5
    W2 = 2.0 * c4 ** 0.25 * math.expm1(d2) ** 0.25
    out.update(d2=d2, W1=W1, W2=W2, mean_error=min(W1, W2), std_error=W2,
               cov_error=2.0 * (math.sqrt(spec) * W2 + W2 * W2))
    return out
