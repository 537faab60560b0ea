"""Test posteriors (counterpart of ``viabel_tpu/models/zoo.py``).

Data come from the same ``np.random.RandomState(seed)`` draws as the JAX
zoo, so both packages hold identical datasets. Each constructor takes the
device and dtype its tensors live on.
"""

import math

import numpy as np
import torch

from .base import Model

__all__ = ["funnel", "logistic_regression"]

_LOG_2PI = math.log(2.0 * math.pi)


def _norm_logpdf(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z**2 - log_scale - 0.5 * _LOG_2PI


def funnel(log_sigma_stdev=1.0):
    """Neal's funnel, d=2: ``log_sigma ~ N(0, log_sigma_stdev)``,
    ``mu ~ N(0, exp(log_sigma))``. It holds no tensors, so it runs on the
    device and dtype of its input."""

    def log_density(x):
        mu, log_sigma = x[:, 0], x[:, 1]
        return (_norm_logpdf(log_sigma, 0.0, log_sigma_stdev)
                + _norm_logpdf(mu, 0.0, torch.exp(log_sigma)))

    return Model(log_density), 2


def logistic_regression(dim=500, n_data=1000, seed=0, prior_scale=1.0,
                        device="cpu", dtype=None):
    """Bayesian logistic regression with synthetic data.

    ``beta ~ N(0, prior_scale^2 I)``; ``y_i ~ Bernoulli(sigmoid(x_i @
    beta))`` with ``x`` standard normal over ``sqrt(dim)`` and labels
    drawn from a fixed true beta.
    """
    dtype = dtype or torch.get_default_dtype()
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
