"""Bayesian logistic regression with synthetic data (the zoo's model).

``x_i ~ N(0, I / d)`` (n rows), labels ``y_i ~ Bernoulli(sigmoid(x_i .
beta_true))`` with ``beta_true ~ N(0, I)``, all drawn in that order from
``numpy.random.RandomState(seed)``; prior ``beta ~ N(0, prior_scale^2
I)``. The data are kept in float64 and cast to the reference's dtype.
"""

import math

import numpy as np
import torch


def data(dim, n_data, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_data, dim) / np.sqrt(dim)
    beta_true = rng.randn(dim)
    p = 1.0 / (1.0 + np.exp(-(x @ beta_true)))
    y = (rng.rand(n_data) < p).astype(np.float64)
    return x, y


def build(dim, n_data, data_seed, dtype, device, prior_scale=1.0):
    x_np, y_np = data(dim, n_data, data_seed)
    xt = torch.as_tensor(x_np.T.copy(), dtype=dtype, device=device)
    y = torch.as_tensor(y_np, dtype=dtype, device=device)
    log_norm = math.log(prior_scale) + 0.5 * math.log(2.0 * math.pi)

    def log_density(beta):
        logits = beta @ xt
        loglik = torch.sum(y * logits - torch.logaddexp(logits.new_zeros(()), logits), dim=-1)
        logprior = torch.sum(-0.5 * (beta / prior_scale) ** 2, dim=-1) - dim * log_norm
        return loglik + logprior

    return log_density
