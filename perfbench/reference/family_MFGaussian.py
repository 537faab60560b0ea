"""Mean-field Gaussian ``N(mu, diag(sigma^2))``.

Flat parameters ``[mu (d), log_sigma (d)]``; the start is ``mu = 0``,
``log_sigma = init_log_sigma``. A draw is ``mu + sigma z`` for a
standard normal row ``z``.
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Family:
    def __init__(self, dim, init_log_sigma=2.0):
        self.dim = int(dim)
        self.init_log_sigma = float(init_log_sigma)

    def leaves(self):
        d = self.dim
        return {"mu": slice(0, d), "log_sigma": slice(d, 2 * d)}

    def init(self, dtype, device):
        d = self.dim
        return torch.cat([torch.zeros(d, dtype=dtype, device=device),
                          torch.full((d,), self.init_log_sigma, dtype=dtype, device=device)])

    def draws(self, vp, z):
        d = self.dim
        return vp[:d] + torch.exp(vp[d:]) * z

    def entropy(self, vp):
        return 0.5 * self.dim * (1.0 + _LOG_2PI) + torch.sum(vp[self.dim:])

    def log_q(self, vp, x):
        d = self.dim
        w = (x - vp[:d]) / torch.exp(vp[d:])
        return -0.5 * torch.sum(w * w, dim=-1) - torch.sum(vp[d:]) - 0.5 * d * _LOG_2PI

    def moments(self, vp):
        """``E||X - EX||^2``, ``E||X - EX||^4`` and the covariance's spectral
        norm: ``sum sigma^2``, ``2 sum sigma^4 + (sum sigma^2)^2``, ``max
        sigma^2``."""
        var = torch.exp(2.0 * vp[self.dim:])
        c2 = torch.sum(var)
        return c2, 2.0 * torch.sum(var * var) + c2 * c2, torch.max(var)
