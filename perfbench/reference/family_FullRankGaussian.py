"""Full-rank Gaussian ``N(mu, L L^T)``.

Flat parameters ``[mu (d), theta (d*d, row-major)]`` with ``L =
tril(theta, -1) + diag(exp(diag(theta)))``; the start is ``mu = 0``,
``theta = init_log_diag * I``. A draw is ``mu + z L^T`` for a standard
normal row ``z``.
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Family:
    def __init__(self, dim, init_log_diag=0.0):
        self.dim = int(dim)
        self.init_log_diag = float(init_log_diag)

    def leaves(self):
        d = self.dim
        return {"mu": slice(0, d), "theta": slice(d, d + d * d)}

    def init(self, dtype, device):
        d = self.dim
        theta = self.init_log_diag * torch.eye(d, dtype=dtype, device=device)
        return torch.cat([torch.zeros(d, dtype=dtype, device=device), theta.reshape(-1)])

    def unpack(self, vp):
        d = self.dim
        theta = vp[d:].reshape(d, d)
        L = torch.tril(theta, -1) + torch.diag(torch.exp(torch.diagonal(theta)))
        return vp[:d], L

    def draws(self, vp, z):
        mu, L = self.unpack(vp)
        return mu + z @ L.T

    def entropy(self, vp):
        d = self.dim
        theta = vp[d:].reshape(d, d)
        return 0.5 * d * (1.0 + _LOG_2PI) + torch.sum(torch.diagonal(theta))

    def log_q(self, vp, x):
        mu, L = self.unpack(vp)
        w = torch.linalg.solve_triangular(L, (x - mu).T, upper=False)
        return (-0.5 * torch.sum(w * w, dim=0) - torch.sum(torch.log(torch.diagonal(L)))
                - 0.5 * self.dim * _LOG_2PI)

    def moments(self, vp):
        """``E||X - EX||^2``, ``E||X - EX||^4`` and the spectral norm of the
        covariance: with ``Sigma = L L^T``, ``tr Sigma``, ``2 ||Sigma||_F^2 +
        (tr Sigma)^2`` and the largest singular value of L, squared."""
        _, L = self.unpack(vp)
        c2 = torch.sum(L * L)
        sigma = L @ L.T
        c4 = 2.0 * torch.sum(sigma * sigma) + c2 * c2
        return c2, c4, torch.linalg.svdvals(L)[0] ** 2
