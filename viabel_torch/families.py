"""Variational approximation families (counterpart of ``viabel_tpu/families.py``).

Each family describes a distribution through a flat variational-parameter
tensor ``var_param``; sampling takes an explicit ``torch.Generator``.
The flat layouts match the JAX package exactly, so parameters move 1:1
between the packages (:mod:`viabel_torch.convert`):

- ``MFGaussian``: ``[mu (d), log_sigma (d)]``;
- ``FullRankGaussian``: ``[mu (d), theta (d*d, row-major)]`` with
  ``L = tril(theta, -1) + diag(exp(diag theta))``; the strictly-upper
  triangle of ``theta`` is unused (zero gradient, never read).

Families carry the ``device`` and ``dtype`` their parameters live on; the
device defaults to ``"cuda"`` and raises where no card is present.
"""

import math

import torch

from .ops.trsm import (KERNEL_MAX_DIM, cholesky_factor, stl_transpose_solve,
                       vmem_solve_triangular)
from .utils import check_device, deferred_names, ensure_2d

__all__ = ["ApproximationFamily", "MFGaussian", "FullRankGaussian"]

#: families of the JAX package not ported yet, by ROADMAP.md item
NOT_PORTED = {"MFStudentT": 9, "MultivariateT": 9, "LRGaussian": 9,
              "NeuralNet": 9, "NVPFlow": 9}
__getattr__ = deferred_names(__name__, NOT_PORTED)

_LOG_2PI = math.log(2.0 * math.pi)


class _TriSolve(torch.autograd.Function):
    """``T^{-1} B`` through :func:`vmem_solve_triangular`, with the adjoint
    of the JAX package's ``blocked_solve_triangular`` (ops/trsm.py:112-122):
    ``dB = T^{-T} g`` by the same kernel with ``lower`` flipped, and
    ``dT = -dB X^T`` masked to T's triangle, formed only when asked for."""

    @staticmethod
    def forward(ctx, T, B, lower):
        X = vmem_solve_triangular(T, B, lower)
        ctx.save_for_backward(T, X)
        ctx.lower = lower
        return X

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        T, X = ctx.saved_tensors
        dB = vmem_solve_triangular(T.mT, g, not ctx.lower)
        dT = None
        if ctx.needs_input_grad[0]:
            dT = -dB @ X.mT
            dT = torch.tril(dT) if ctx.lower else torch.triu(dT)
        return dT, dB if ctx.needs_input_grad[1] else None, None


def _tri_solve(T, B, lower=True):
    """Differentiable triangular solve. A CUDA ``T`` with ``d <=
    KERNEL_MAX_DIM`` goes through the kernel (:class:`_TriSolve`); the CPU
    and larger ``d`` take ``torch.linalg.solve_triangular``. The JAX
    package sends ``d >= 256`` to its TPU-only blocked solve instead
    (families.py:55-63); the function computed is the same."""
    if T.is_cuda and T.shape[0] <= KERNEL_MAX_DIM:
        return _TriSolve.apply(T, B, lower)
    return torch.linalg.solve_triangular(T, B, upper=not lower)


class ApproximationFamily:
    """Abstract base for variational approximation families."""

    def __init__(self, dim, var_param_dim, supports_entropy, supports_kl,
                 device="cuda", dtype=None, base_sampler=None):
        self._dim = int(dim)
        self._var_param_dim = int(var_param_dim)
        self._supports_entropy = bool(supports_entropy)
        self._supports_kl = bool(supports_kl)
        self._device = check_device(device)
        self._dtype = dtype or torch.get_default_dtype()
        self._base_sampler = base_sampler

    @property
    def base_sampler(self):
        """The standard-normal base sampler, or ``None`` for pseudo-random
        draws from the generator. A sampler has a method
        ``normal(generator, n_samples, width, dtype, device)``."""
        return self._base_sampler

    def _base_normal(self, generator, n_samples, width, dtype, device):
        if self._base_sampler is None:
            return torch.randn((n_samples, width), generator=generator,
                               dtype=dtype, device=device)
        return self._base_sampler.normal(generator, n_samples, width, dtype,
                                         device)

    @property
    def supports_entropy(self):
        return self._supports_entropy

    @property
    def supports_kl(self):
        return self._supports_kl

    def supports_pth_moment(self, p):
        raise NotImplementedError()

    @property
    def dim(self):
        """Dimension of the space the distribution is defined on."""
        return self._dim

    @property
    def var_param_dim(self):
        """Dimension of the flat variational parameter."""
        return self._var_param_dim

    @property
    def device(self):
        return self._device

    @property
    def dtype(self):
        return self._dtype

    def _zeros(self, n):
        return torch.zeros(n, dtype=self._dtype, device=self._device)

    def init_param(self):
        return self._zeros(self.var_param_dim)

    def sample(self, var_param, n_samples, generator):
        """Draw ``(n_samples, dim)`` reparameterized samples."""
        raise NotImplementedError()

    def entropy(self, var_param):
        if self._supports_entropy:
            return self._entropy(var_param)
        raise NotImplementedError()

    def _entropy(self, var_param):
        raise NotImplementedError()

    def kl(self, var_param0, var_param1):
        """KL(q(var_param0) || q(var_param1)) in closed form."""
        if self._supports_kl:
            return self._kl(var_param0, var_param1)
        raise NotImplementedError()

    def _kl(self, var_param0, var_param1):
        raise NotImplementedError()

    def log_density(self, var_param, x):
        raise NotImplementedError()

    def sample_and_entropy(self, var_param, n_samples, generator):
        return (self.sample(var_param, n_samples, generator),
                self.entropy(var_param))

    def sample_and_stl_log_density(self, var_param, n_samples, generator):
        """Samples plus the "sticking the landing" log density, evaluated
        at detached parameters so gradients flow only through the samples
        (Roeder et al. 2017)."""
        samples = self.sample(var_param, n_samples, generator)
        return samples, self.log_density(var_param.detach(), samples)

    def mean_and_cov(self, var_param):
        raise NotImplementedError()

    def pth_moment(self, var_param, p):
        """Central absolute pth moment ``E ||X - E X||^p``."""
        if self.supports_pth_moment(p):
            return self._pth_moment(var_param, p)
        raise ValueError(f"p = {p} is not a supported moment")

    def _pth_moment(self, var_param, p):
        raise NotImplementedError()


class MFGaussian(ApproximationFamily):
    """Mean-field Gaussian, ``var_param = [mu, log_sigma]``."""

    def __init__(self, dim, base_sampler=None, device="cuda", dtype=None):
        super().__init__(dim, 2 * dim, True, True, device, dtype, base_sampler)

    def unpack(self, var_param):
        return var_param[: self.dim], var_param[self.dim:]

    def init_param(self):
        # mu = 0, log_sigma = 2 (reference approximations.py:207-210)
        return torch.cat([self._zeros(self.dim), 2.0 + self._zeros(self.dim)])

    def sample(self, var_param, n_samples, generator):
        mu, log_sigma = self.unpack(var_param)
        z = self._base_normal(generator, n_samples, self.dim, var_param.dtype,
                              var_param.device)
        return mu + torch.exp(log_sigma) * z

    def _entropy(self, var_param):
        _, log_sigma = self.unpack(var_param)
        return 0.5 * self.dim * (1.0 + _LOG_2PI) + torch.sum(log_sigma)

    def _kl(self, var_param0, var_param1):
        mu0, ls0 = self.unpack(var_param0)
        mu1, ls1 = self.unpack(var_param1)
        dls = ls0 - ls1
        return 0.5 * torch.sum(torch.exp(2.0 * dls) + (mu0 - mu1) ** 2
                               / torch.exp(2.0 * ls1) - 2.0 * dls - 1.0)

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        x = ensure_2d(x)
        mu, log_sigma = self.unpack(var_param)
        z = (x - mu) / torch.exp(log_sigma)
        out = torch.sum(-0.5 * z**2 - log_sigma - 0.5 * _LOG_2PI, dim=-1)
        return out[0] if squeeze else out

    def mean_and_cov(self, var_param):
        mu, log_sigma = self.unpack(var_param)
        return mu, torch.diag(torch.exp(2.0 * log_sigma))

    def _pth_moment(self, var_param, p):
        _, log_sigma = self.unpack(var_param)
        variances = torch.exp(2.0 * log_sigma)
        if p == 2:
            return torch.sum(variances)
        # p == 4 (reference approximations.py:242-248)
        return 2.0 * torch.sum(variances**2) + torch.sum(variances) ** 2

    def supports_pth_moment(self, p):
        return p in (2, 4)


class _CholeskyFamily(ApproximationFamily):
    """Dense Cholesky packing ``[mu (d), theta (d*d)]`` for full-rank
    families; only ``tril(theta)`` is read."""

    def __init__(self, dim, supports_entropy, supports_kl, device, dtype,
                 base_sampler):
        super().__init__(dim, dim + dim * dim, supports_entropy, supports_kl,
                         device, dtype, base_sampler)

    def unpack(self, var_param):
        """Return ``(mu, log_diag, L)`` with ``L`` lower-triangular."""
        d = self.dim
        theta = var_param[d:].view(d, d)
        return var_param[:d], torch.diagonal(theta), cholesky_factor(theta)

    def _init_chol_param(self, init_log_diag):
        d = self.dim
        theta = init_log_diag * torch.eye(d, dtype=self._dtype, device=self._device)
        return torch.cat([self._zeros(d), theta.reshape(-1)])

    def _chol_whiten(self, L, x, mu):
        """``L^{-1}(x - mu)^T`` for batched x: ``(d, n)``."""
        return _tri_solve(L, (ensure_2d(x) - mu).T, lower=True)


class _STLAttach(torch.autograd.Function):
    """The "sticking the landing" log-density hook: the value is the
    precomputed (parameter-detached) ``const``; the gradient enters only
    through the samples, ``d log q / dx = -v``, with ``v`` precomputed
    under detached parameters (the JAX package's ``_stl_attach``)."""

    @staticmethod
    def forward(ctx, x, v, const):
        ctx.save_for_backward(v)
        return const.clone()

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return -v * g[:, None], None, None


def _stl_whiten_T(theta_stop, L_stop, w_stop):
    """``L^{-T} w`` under detached parameters: the STL score direction.

    Up to ``KERNEL_MAX_DIM`` this is :func:`stl_transpose_solve`, which on
    a CUDA tensor launches the kernel that forms the factor from
    ``theta``; above it, a library triangular solve on the formed factor.
    That is the JAX package's own size rule (families.py:508-510).
    """
    if theta_stop.shape[0] <= KERNEL_MAX_DIM:
        return stl_transpose_solve(theta_stop, w_stop.T.contiguous()).T
    return _tri_solve(L_stop.T, w_stop.T, lower=False).T


class FullRankGaussian(_CholeskyFamily):
    """Full-rank Gaussian, ``Sigma = L L^T``; sampling is ``mu + z @ L.T``."""

    def __init__(self, dim, init_log_diag=0.0, base_sampler=None,
                 device="cuda", dtype=None):
        self._init_log_diag = float(init_log_diag)
        super().__init__(dim, True, True, device, dtype, base_sampler)

    def init_param(self):
        return self._init_chol_param(self._init_log_diag)

    def _draw(self, var_param, n_samples, generator):
        mu, log_diag, L = self.unpack(var_param)
        z = self._base_normal(generator, n_samples, self.dim, var_param.dtype,
                              var_param.device)
        return z, mu + z @ L.T, log_diag, L

    def sample(self, var_param, n_samples, generator):
        return self._draw(var_param, n_samples, generator)[1]

    def sample_and_entropy(self, var_param, n_samples, generator):
        _, samples, log_diag, _ = self._draw(var_param, n_samples, generator)
        return samples, 0.5 * self.dim * (1.0 + _LOG_2PI) + torch.sum(log_diag)

    def sample_and_stl_log_density(self, var_param, n_samples, generator):
        d = self.dim
        z, samples, log_diag, L = self._draw(var_param, n_samples, generator)
        # value via the identity L^{-1}(x - mu) == z (no forward solve);
        # score direction L^{-T} z under detached params (one solve)
        theta_s = var_param.detach()[d:].view(d, d)
        v = _stl_whiten_T(theta_s, L.detach(), z)
        const = (-0.5 * torch.sum(z**2, dim=-1) - torch.sum(log_diag.detach())
                 - 0.5 * d * _LOG_2PI)
        return samples, _STLAttach.apply(samples, v, const)

    def _entropy(self, var_param):
        _, log_diag, _ = self.unpack(var_param)
        return 0.5 * self.dim * (1.0 + _LOG_2PI) + torch.sum(log_diag)

    def _kl(self, var_param0, var_param1):
        mu0, ld0, L0 = self.unpack(var_param0)
        mu1, ld1, L1 = self.unpack(var_param1)
        # tr(Sigma1^{-1} Sigma0) = ||L1^{-1} L0||_F^2
        M = _tri_solve(L1, L0, lower=True)
        trace_term = torch.sum(M**2)
        y = _tri_solve(L1, (mu0 - mu1)[:, None], lower=True)[:, 0]
        maha = torch.sum(y**2)
        logdet_diff = 2.0 * (torch.sum(ld1) - torch.sum(ld0))
        return 0.5 * (logdet_diff - self.dim + trace_term + maha)

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        mu, log_diag, L = self.unpack(var_param)
        y = self._chol_whiten(L, x, mu)
        out = (-0.5 * torch.sum(y**2, dim=0) - torch.sum(log_diag)
               - 0.5 * self.dim * _LOG_2PI)
        return out[0] if squeeze else out

    def mean_and_cov(self, var_param):
        mu, _, L = self.unpack(var_param)
        return mu, L @ L.T

    def _pth_moment(self, var_param, p):
        _, _, L = self.unpack(var_param)
        # eigenvalue sums via trace/Frobenius identities (no eigh)
        trace = torch.sum(L**2)  # tr(L L^T)
        if p == 2:
            return trace
        frob_sq = torch.sum((L.T @ L) ** 2)  # ||Sigma||_F^2 = ||L^T L||_F^2
        return 2.0 * frob_sq + trace**2

    def supports_pth_moment(self, p):
        return p in (2, 4)
