"""Test posteriors (counterpart of ``viabel_tpu/models/zoo.py``).

Data come from the same ``np.random.RandomState(seed)`` draws as the JAX
zoo, so both packages hold identical datasets. Each constructor that holds
tensors takes the device (default ``"cuda"``; it raises where no card is
present) and dtype they live on.
"""

import math

import numpy as np
import torch

from ..utils import check_device
from .base import Model

__all__ = ["funnel", "correlated_gaussian", "diagonal_gaussian",
           "gaussian_mixture", "robust_regression", "eight_schools",
           "logistic_regression"]

_LOG_2PI = math.log(2.0 * math.pi)


def _norm_logpdf(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z**2 - log_scale - 0.5 * _LOG_2PI


def _t_logpdf(x, df, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    return (math.lgamma(0.5 * (df + 1.0)) - math.lgamma(0.5 * df)
            - 0.5 * math.log(math.pi * df) - math.log(scale)
            - 0.5 * (df + 1.0) * torch.log1p(z**2 / df))


def _tensor(values, device, dtype):
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           dtype=dtype or torch.get_default_dtype(),
                           device=check_device(device))


def funnel(log_sigma_stdev=1.0):
    """Neal's funnel, d=2: ``log_sigma ~ N(0, log_sigma_stdev)``,
    ``mu ~ N(0, exp(log_sigma))``. It holds no tensors, so it runs on the
    device and dtype of its input."""

    def log_density(x):
        mu, log_sigma = x[:, 0], x[:, 1]
        return (_norm_logpdf(log_sigma, 0.0, log_sigma_stdev)
                + _norm_logpdf(mu, 0.0, torch.exp(log_sigma)))

    return Model(log_density), 2


def correlated_gaussian(dim=2, rho=0.8, device="cuda", dtype=None):
    """Zero-mean Gaussian with AR(1)-style correlation ``rho``. Returns
    ``(model, dim, info)`` with ``info["mean"]`` and ``info["cov"]``. The
    log density whitens with a library triangular solve on its own fixed
    factor, as the JAX zoo keeps ``jax.scipy`` there."""
    idx = np.arange(dim)
    cov_np = rho ** np.abs(idx[:, None] - idx[None, :])
    L = _tensor(np.linalg.cholesky(cov_np), device, dtype)
    log_det = torch.sum(torch.log(torch.diagonal(L)))

    def log_density(x):
        y = torch.linalg.solve_triangular(L, x.T, upper=False)
        return -0.5 * torch.sum(y**2, dim=0) - log_det - 0.5 * dim * _LOG_2PI

    info = {"mean": torch.zeros(dim, dtype=L.dtype, device=L.device),
            "cov": _tensor(cov_np, device, dtype)}
    return Model(log_density), dim, info


def diagonal_gaussian(mean, stdev, device="cuda", dtype=None):
    """Diagonal-Gaussian target (the reference's recovery tests)."""
    mean, stdev = _tensor(mean, device, dtype), _tensor(stdev, device, dtype)

    def log_density(x):
        return torch.sum(_norm_logpdf(x, mean, stdev), dim=-1)

    return Model(log_density), int(mean.shape[0])


def gaussian_mixture(means=((-3.0, -3.0), (3.0, 3.0)), stdev=1.0, weights=None,
                     device="cuda", dtype=None):
    """Isotropic Gaussian mixture, ``log p(x) = logsumexp_k [log w_k + log
    N(x; m_k, stdev^2 I)]``; ``weights`` default uniform. Returns ``(model,
    dim, info)`` with ``info["means"]``, ``info["weights"]``, ``info["stdev"]``."""
    means = _tensor(means, device, dtype)
    if means.dim() != 2:
        raise ValueError("means must have shape (n_modes, dim)")
    n_modes, dim = means.shape
    w = (np.full(n_modes, 1.0 / n_modes) if weights is None
         else np.asarray(weights, dtype=float) / np.sum(weights))
    log_w = _tensor(np.log(w), device, dtype)

    def log_density(x):
        comp = torch.sum(_norm_logpdf(x[:, None, :], means[None], stdev), dim=-1)
        return torch.logsumexp(comp + log_w[None, :], dim=-1)

    info = {"means": means, "weights": _tensor(w, device, dtype),
            "stdev": float(stdev)}
    return Model(log_density), int(dim), info


def robust_regression(n_data=25, df=40.0, beta_gen=(-2.0, 1.0), seed=5039,
                      device="cuda", dtype=None):
    """Robust (Student-t likelihood) linear regression, d=2: ``x ~ N(0, I)
    @ [[1, .75], [.75, 1]]``, ``y = x @ beta + t(df)`` noise, centered;
    prior ``beta ~ N(0, 10)``."""
    rng = np.random.RandomState(seed)
    beta_gen = np.asarray(beta_gen)
    x_np = rng.randn(n_data, 2).dot(np.array([[1.0, 0.75], [0.75, 1.0]]))
    y_np = x_np.dot(beta_gen) + rng.standard_t(df, n_data)
    y_np = y_np - np.mean(y_np)
    x, y = _tensor(x_np, device, dtype), _tensor(y_np, device, dtype)

    def log_density(beta):
        pred = beta @ x.T  # (n, N)
        loglik = torch.sum(_t_logpdf(y[None, :], df, pred, 1.0), dim=-1)
        logprior = torch.sum(_norm_logpdf(beta, 0.0, 10.0), dim=-1)
        return loglik + logprior

    return Model(log_density), 2


_EIGHT_SCHOOLS_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
_EIGHT_SCHOOLS_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


def eight_schools(device="cuda", dtype=None):
    """Eight-schools hierarchical model, non-centered, d=10: parameters
    ``[mu, log_tau, eta_1..eta_8]``, ``theta_j = mu + tau * eta_j``,
    ``mu ~ N(0, 5)``, ``tau ~ HalfCauchy(5)`` with the log-Jacobian of
    ``tau = exp(log_tau)``, ``eta_j ~ N(0, 1)``, ``y_j ~ N(theta_j, sigma_j)``."""
    y = _tensor(_EIGHT_SCHOOLS_Y, device, dtype)
    sigma = _tensor(_EIGHT_SCHOOLS_SIGMA, device, dtype)

    def log_density(x):
        mu, log_tau, eta = x[:, 0], x[:, 1], x[:, 2:]
        tau = torch.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * eta
        loglik = torch.sum(_norm_logpdf(y[None, :], theta, sigma[None, :]), dim=-1)
        lp = _norm_logpdf(mu, 0.0, 5.0)
        lp = lp + (math.log(2.0 / math.pi) - math.log(5.0)
                   - torch.log1p((tau / 5.0) ** 2) + log_tau)
        lp = lp + torch.sum(_norm_logpdf(eta), dim=-1)
        return loglik + lp

    return Model(log_density), 10


def logistic_regression(dim=500, n_data=1000, seed=0, prior_scale=1.0,
                        device="cuda", dtype=None):
    """Bayesian logistic regression with synthetic data.

    ``beta ~ N(0, prior_scale^2 I)``; ``y_i ~ Bernoulli(sigmoid(x_i @
    beta))`` with ``x`` standard normal over ``sqrt(dim)`` and labels
    drawn from a fixed true beta.
    """
    dtype = dtype or torch.get_default_dtype()
    device = check_device(device)
    rng = np.random.RandomState(seed)
    x_np = rng.randn(n_data, dim) / np.sqrt(dim)
    beta_true = rng.randn(dim)
    logits = x_np @ beta_true
    y_np = (rng.rand(n_data) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    xt = torch.as_tensor(x_np.T.copy(), dtype=dtype, device=device)  # (dim, N)
    y = torch.as_tensor(y_np, dtype=dtype, device=device)

    def log_density(beta):
        logits = beta @ xt  # (n, N)
        loglik = torch.sum(y * logits - torch.logaddexp(
            torch.zeros((), dtype=logits.dtype, device=logits.device), logits), dim=-1)
        logprior = torch.sum(_norm_logpdf(beta, 0.0, prior_scale), dim=-1)
        return loglik + logprior

    return Model(log_density), dim
