"""Variational approximation families (counterpart of ``viabel_tpu/families.py``).

Each family describes a distribution through a flat variational-parameter
tensor ``var_param``; sampling takes an explicit ``torch.Generator``.
The flat layouts match the JAX package exactly, so parameters move 1:1
between the packages (:mod:`viabel_torch.convert`):

- ``MFGaussian``, ``MFStudentT``: ``[mu (d), log_sigma (d)]``;
- ``FullRankGaussian``, ``MultivariateT``: ``[mu (d), theta (d*d,
  row-major)]`` with ``L = tril(theta, -1) + diag(exp(diag theta))``; the
  strictly-upper triangle of ``theta`` is unused (zero gradient, never
  read);
- ``LRGaussian``: ``[mu (d), log_sigma (d), B (d*k, row-major)]`` with
  ``Sigma = B B^T + diag(exp(2 log_sigma))``;
- ``NeuralNet``: per layer ``W (m*n, row-major)`` then ``b (n)``;
- ``NVPFlow`` and ``RealNVP``: per coupling the ``t`` network's then the
  ``s`` network's ``NeuralNet`` parameters.

Families carry the ``device`` and ``dtype`` their parameters live on; the
device defaults to ``"cuda"`` and raises where no card is present.
"""

import math

import torch
from torch import func

from .ops.mfstl import mf_stl_backward, mf_stl_forward
from .ops.trsm import (KERNEL_MAX_DIM, cholesky_factor, stl_transpose_solve,
                       vmem_solve_triangular)
from .tracing import span
from .utils import GraphSafety, check_device, chisquare, ensure_2d

__all__ = ["ApproximationFamily", "MFGaussian", "MFStudentT", "FullRankGaussian",
           "MultivariateT", "LRGaussian", "NeuralNet", "NVPFlow", "RealNVP"]

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


class _MFSTL(torch.autograd.Function):
    """MFGaussian's STL draw and score on the card: ``(x, log q)`` from
    base normals ``z`` by :func:`mf_stl_forward`, and ``var_param``'s
    gradient from the draws' and the scores' by :class:`_MFSTLGrad`,
    which differentiates again (``create_graph``) as the composite
    ``sample`` and ``log_density`` do."""

    @staticmethod
    def forward(ctx, var_param, z):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(var_param, z)
        return mf_stl_forward(var_param, z)

    @staticmethod
    def backward(ctx, g_x, g_lq):
        var_param, z = ctx.saved_tensors
        return _MFSTLGrad.apply(var_param, z, g_x, g_lq), None


class _MFSTLGrad(torch.autograd.Function):
    """The STL gradient ``[A, B]``, ``A = sum_s G``, ``B = sigma sum_s G z``
    with ``G = g_x - g_lq (x - mu) / sigma^2`` at stopped ``mu`` and
    ``sigma`` (value ``g_x - g_lq z / sigma``), by :func:`mf_stl_backward`;
    its own backward is the analytic product with the cotangent ``(a, b)``.
    With ``H = a + b sigma z``: ``g_x`` takes ``H``, ``g_lq`` takes
    ``-sum_j H z / sigma``, ``mu`` (through ``x``) ``-sum_s g_lq H /
    sigma^2``, and ``log_sigma`` ``b B`` (``B``'s own ``sigma``) plus
    ``-sum_s g_lq H z / sigma`` (through ``x``)."""

    @staticmethod
    def forward(ctx, var_param, z, g_x, g_lq):
        grad = mf_stl_backward(var_param, z, g_x, g_lq)
        ctx.save_for_backward(var_param, z, g_x, g_lq, grad)
        return grad

    @staticmethod
    def backward(ctx, out):
        var_param, z, g_x, g_lq, grad = ctx.saved_tensors
        d = z.shape[1]
        a, b = out[:d], out[d:]
        sigma = torch.exp(var_param[d:])
        H = a + b * sigma * z
        d_var = torch.cat([torch.zeros_like(a), b * grad[d:]])
        d_lq = None
        if g_lq is not None:
            d_lq = -torch.sum(H * z / sigma, dim=1)
            w = g_lq[:, None] * H
            d_var = d_var - torch.cat([w.sum(0) / (sigma * sigma),
                                       (w * z).sum(0) / sigma])
        return d_var, None, None if g_x is None else H, d_lq


class ApproximationFamily(GraphSafety):
    """Abstract base for variational approximation families. A family that
    draws through a ``base_sampler`` runs the sampler's host code every
    step, so a CUDA graph never replays it (:class:`GraphSafety`)."""

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

    def graph_refusal(self):
        if self._base_sampler is not None:
            return "the family draws through a base_sampler, host code run every step"
        return super().graph_refusal()

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

    def _broadcast_affine(self, loc, scale):
        """``(loc, scale)`` as ``(dim,)`` tensors in the family's dtype and
        on its device."""
        def vec(v):
            v = torch.as_tensor(v, dtype=self._dtype, device=self._device)
            return torch.broadcast_to(v, (self.dim,))

        return vec(loc), vec(scale)

    def fold_affine(self, var_param, loc, scale):
        """Parameters of the pushforward of ``q`` through ``x -> loc +
        scale * x``.

        For the location-scale families the elementwise affine map acts on
        the variational parameters in closed form: if ``X ~ q(var_param)``
        then ``loc + scale * X ~ q(fold_affine(var_param, loc, scale))``
        exactly. This lets ``bbvi(standardize=True)`` optimize against a
        pilot-standardized target and return ``opt_param`` in the user's
        coordinates. ``scale`` must be positive; ``loc`` and ``scale`` may
        be scalars or ``(dim,)`` vectors. The inverse map is
        ``fold_affine(vp, -loc / scale, 1 / scale)``. Families without a
        closed-form affine action (NeuralNet, NVPFlow) raise
        ``NotImplementedError``.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no closed-form affine pushforward; "
            "optimize in the standardized space and map draws back with "
            "spec.constrain instead")


class _MeanFieldLocScale(ApproximationFamily):
    """The mean-field ``[mu, log_sigma]`` layout. Subclasses define
    ``mean_and_stdevs(var_param) -> (mean, stdevs)``, the O(d) hook of
    ExclusiveKL's control-variate estimators."""

    def __init__(self, dim, supports_entropy, supports_kl, device, dtype,
                 base_sampler=None, init_log_sigma=2.0):
        super().__init__(dim, 2 * dim, supports_entropy, supports_kl, device,
                         dtype, base_sampler)
        self._init_log_sigma = float(init_log_sigma)

    def unpack(self, var_param):
        return var_param[: self.dim], var_param[self.dim:]

    def init_param(self):
        # mu = 0, log_sigma = 2 by default (reference approximations.py:207-210)
        return torch.cat([self._zeros(self.dim),
                          self._init_log_sigma + self._zeros(self.dim)])

    def fold_affine(self, var_param, loc, scale):
        """Exact affine pushforward: ``mu' = loc + scale * mu``,
        ``log_sigma' = log_sigma + log scale``."""
        loc, scale = self._broadcast_affine(loc, scale)
        mu, log_sigma = self.unpack(var_param)
        return torch.cat([loc + scale * mu, log_sigma + torch.log(scale)])


class MFGaussian(_MeanFieldLocScale):
    """Mean-field Gaussian, ``var_param = [mu, log_sigma]``.

    ``init_param`` starts at ``mu = 0`` and ``log_sigma = init_log_sigma``
    in every coordinate. The default 2.0 (sigma = 7.4) is the reference's
    start; a posterior over a network's weights wants its prior's scale
    instead (``init_log_sigma=0.0`` under a unit Gaussian prior), as
    ``FullRankGaussian`` takes ``init_log_diag``.
    """

    graph_safe = True

    def __init__(self, dim, init_log_sigma=2.0, base_sampler=None, device="cuda",
                 dtype=None):
        super().__init__(dim, True, True, device, dtype, base_sampler,
                         init_log_sigma=init_log_sigma)

    def sample(self, var_param, n_samples, generator):
        mu, log_sigma = self.unpack(var_param)
        z = self._base_normal(generator, n_samples, self.dim, var_param.dtype,
                              var_param.device)
        return mu + torch.exp(log_sigma) * z

    def sample_and_stl_log_density(self, var_param, n_samples, generator):
        """On the CPU, the composite :meth:`sample` and :meth:`log_density`
        at detached parameters; on a card, the same draws through one
        kernel each way (:class:`_MFSTL`, ``csrc/mf_stl.cu``)."""
        if var_param.device.type == "cpu":
            return super().sample_and_stl_log_density(var_param, n_samples, generator)
        z = self._base_normal(generator, n_samples, self.dim, var_param.dtype,
                              var_param.device)
        return _MFSTL.apply(var_param, z)

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

    def mean_and_stdevs(self, var_param):
        mu, log_sigma = self.unpack(var_param)
        return mu, torch.exp(log_sigma)

    def _pth_moment(self, var_param, p):
        _, log_sigma = self.unpack(var_param)
        variances = torch.exp(2.0 * log_sigma)
        if p == 2:
            return torch.sum(variances)
        # p == 4 (reference approximations.py:242-248)
        return 2.0 * torch.sum(variances**2) + torch.sum(variances) ** 2

    def supports_pth_moment(self, p):
        return p in (2, 4)


def _check_df(df):
    if df <= 2:
        raise ValueError("df must be greater than 2")
    return float(df)


def _t_log_norm(df, d):
    """The log normaliser of a d-variate Student-t with unit scale."""
    return (math.lgamma(0.5 * (df + d)) - math.lgamma(0.5 * df)
            - 0.5 * d * math.log(math.pi * df))


class MFStudentT(_MeanFieldLocScale):
    """Mean-field Student-t, ``var_param = [mu, log_sigma]``.

    Each coordinate is ``mu + sigma t`` with ``t = z / sqrt(chi2/df)``
    drawn per coordinate from the generator (:func:`utils.chisquare`). Like
    the JAX package, the entropy drops df-only constants (reference
    approximations.py:276-279), and it has no base-sampler hook.
    """

    graph_safe = True

    def __init__(self, dim, df, device="cuda", dtype=None):
        self._df = _check_df(df)
        super().__init__(dim, True, False, device, dtype)

    @property
    def df(self):
        return self._df

    def sample(self, var_param, n_samples, generator):
        mu, log_sigma = self.unpack(var_param)
        size = (n_samples, self.dim)
        z = torch.randn(size, generator=generator, dtype=var_param.dtype,
                        device=var_param.device)
        chi2 = chisquare(generator, self.df, size, var_param.dtype, var_param.device)
        return mu + torch.exp(log_sigma) * (z / torch.sqrt(chi2 / self.df))

    def _entropy(self, var_param):
        _, log_sigma = self.unpack(var_param)
        return torch.sum(log_sigma)

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        x = ensure_2d(x)
        mu, log_sigma = self.unpack(var_param)
        df = self.df
        z = (x - mu) / torch.exp(log_sigma)
        lp_1d = (_t_log_norm(df, 1) - log_sigma
                 - 0.5 * (df + 1.0) * torch.log1p(z**2 / df))
        out = torch.sum(lp_1d, dim=-1)
        return out[0] if squeeze else out

    def mean_and_cov(self, var_param):
        mu, log_sigma = self.unpack(var_param)
        return mu, self.df / (self.df - 2.0) * torch.diag(torch.exp(2.0 * log_sigma))

    def mean_and_stdevs(self, var_param):
        mu, log_sigma = self.unpack(var_param)
        return mu, math.sqrt(self.df / (self.df - 2.0)) * torch.exp(log_sigma)

    def _pth_moment(self, var_param, p):
        df = self.df
        _, log_sigma = self.unpack(var_param)
        scales = torch.exp(log_sigma)
        c = df / (df - 2.0)
        if p == 2:
            return c * torch.sum(scales**2)
        # p == 4 (reference approximations.py:294-304)
        return c**2 * (2.0 * (df - 1.0) / (df - 4.0) * torch.sum(scales**4)
                       + torch.sum(scales**2) ** 2)

    def supports_pth_moment(self, p):
        return p in (2, 4) and p < self.df


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

    def pack(self, mu, L):
        """Inverse of :meth:`unpack`: ``L`` must be lower-triangular with a
        positive diagonal."""
        theta = torch.tril(L, -1) + torch.diag(torch.log(torch.diagonal(L)))
        return torch.cat([mu, theta.reshape(-1)])

    def fold_affine(self, var_param, loc, scale):
        """Exact affine pushforward: ``mu' = loc + scale * mu``, ``L' =
        diag(scale) @ L``: the stored ``theta`` gets ``log scale_r`` added on
        the diagonal and row ``r`` of its strict lower triangle scaled by
        ``scale_r``; the unused strict upper triangle is left as it is."""
        loc, scale = self._broadcast_affine(loc, scale)
        d = self.dim
        theta = var_param[d:].view(d, d)
        rows = torch.arange(d, device=theta.device)[:, None]
        cols = torch.arange(d, device=theta.device)[None, :]
        theta = torch.where(rows == cols, theta + torch.log(scale)[:, None],
                            torch.where(cols < rows, theta * scale[:, None], theta))
        return torch.cat([loc + scale * var_param[:d], theta.reshape(-1)])

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
        return stl_transpose_solve(theta_stop, w_stop.T).T
    return _tri_solve(L_stop.T, w_stop.T, lower=False).T


class FullRankGaussian(_CholeskyFamily):
    """Full-rank Gaussian, ``Sigma = L L^T``; sampling is ``mu + z @ L.T``."""

    graph_safe = True

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


class MultivariateT(_CholeskyFamily):
    """Full-rank multivariate Student-t, ``Sigma = L L^T`` (scale matrix);
    samples are ``mu + (z @ L.T) / sqrt(chi2(df)/df)``.

    ``base_sampler`` (integer ``df`` only): one joint ``(dim + df)``-wide
    base block per draw, whose first ``dim`` coordinates form ``z`` and
    whose last ``df`` form the chi-square mixing variable as the exact sum
    of their squares (the JAX package's QMC route, families.py:644-651).
    Without one, ``z`` and the chi-square come from the generator.
    """

    graph_safe = True

    def __init__(self, dim, df, base_sampler=None, device="cuda", dtype=None):
        df = _check_df(df)
        if base_sampler is not None and df != int(df):
            raise ValueError(
                "QMC base sampling for MultivariateT needs an integer df "
                "(the chi-square mixing variable is built exactly as a sum "
                f"of df squared base normals); got df={df}")
        self._df = df
        super().__init__(dim, True, False, device, dtype, base_sampler)

    @property
    def df(self):
        return self._df

    def init_param(self):
        # Sigma = 10 I (reference approximations.py:337-340)
        return self._init_chol_param(0.5 * math.log(10.0))

    def _draw(self, var_param, n_samples, generator):
        """``(samples, w, log_diag, L)`` with ``w = z / s = L^{-1}(x - mu)``."""
        mu, log_diag, L = self.unpack(var_param)
        d, dtype, device = self.dim, var_param.dtype, var_param.device
        if self._base_sampler is None:
            z = torch.randn((n_samples, d), generator=generator, dtype=dtype,
                            device=device)
            chi2 = chisquare(generator, self.df, (n_samples,), dtype, device)
        else:
            joint = self._base_normal(generator, n_samples, d + int(self.df),
                                      dtype, device)
            z = joint[:, :d]
            chi2 = torch.sum(joint[:, d:] ** 2, dim=-1)
        s = torch.sqrt(chi2 / self.df)[:, None]
        return mu + (z @ L.T) / s, z / s, log_diag, L

    def sample(self, var_param, n_samples, generator):
        return self._draw(var_param, n_samples, generator)[0]

    def sample_and_entropy(self, var_param, n_samples, generator):
        samples, _, log_diag, _ = self._draw(var_param, n_samples, generator)
        return samples, torch.sum(log_diag)

    def sample_and_stl_log_density(self, var_param, n_samples, generator):
        """The whitened deviation equals ``w = z / s`` by construction, so
        the value needs no solve; the score direction ``(df + d)/(df +
        maha) L^{-T} w`` costs one, the STL solve kernel on a CUDA tensor
        (:func:`_stl_whiten_T`)."""
        d, df = self.dim, self.df
        samples, w, log_diag, L = self._draw(var_param, n_samples, generator)
        w_s = w.detach()
        maha = torch.sum(w_s**2, dim=-1)
        theta_s = var_param.detach()[d:].view(d, d)
        v = _stl_whiten_T(theta_s, L.detach(), w_s) * ((df + d) / (df + maha))[:, None]
        const = (_t_log_norm(df, d) - torch.sum(log_diag.detach())
                 - 0.5 * (df + d) * torch.log1p(maha / df))
        return samples, _STLAttach.apply(samples, v, const)

    def _entropy(self, var_param):
        # 0.5 log det Sigma, dropping df-only constants (reference 351-354)
        _, log_diag, _ = self.unpack(var_param)
        return torch.sum(log_diag)

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        mu, log_diag, L = self.unpack(var_param)
        d, df = self.dim, self.df
        maha = torch.sum(self._chol_whiten(L, x, mu) ** 2, dim=0)
        out = (_t_log_norm(df, d) - torch.sum(log_diag)
               - 0.5 * (df + d) * torch.log1p(maha / df))
        return out[0] if squeeze else out

    def mean_and_cov(self, var_param):
        mu, _, L = self.unpack(var_param)
        return mu, self.df / (self.df - 2.0) * (L @ L.T)

    def _pth_moment(self, var_param, p):
        df = self.df
        _, _, L = self.unpack(var_param)
        trace = torch.sum(L**2)
        c = df / (df - 2.0)
        if p == 2:
            return c * trace
        frob_sq = torch.sum((L.T @ L) ** 2)
        return c**2 * (2.0 * (df - 1.0) / (df - 4.0) * frob_sq + trace**2)

    def supports_pth_moment(self, p):
        return p in (2, 4) and p < self.df


class LRGaussian(ApproximationFamily):
    """Low-rank-plus-diagonal Gaussian, ``Sigma = B B^T + diag(exp(2
    log_sigma))``, with every determinant and solve in the k x k
    capacitance matrix ``C = I_k + B^T D^{-1} B`` (Woodbury and the
    matrix-determinant lemma). ``k`` is required, as in the JAX package.

    Departure: the JAX ``init_param`` draws ``B ~ N(0, 1)`` from
    ``jax.random.PRNGKey(1)``, which torch cannot reproduce; here ``B`` is
    drawn from a torch generator seeded with 1 (or the one passed), so
    the two packages start from different ``B``. Carry a JAX start across
    with :func:`viabel_torch.convert.params_from_jax`.
    """

    graph_safe = True

    def __init__(self, dim, k, base_sampler=None, device="cuda", dtype=None):
        self._k = int(k)
        super().__init__(dim, 2 * dim + dim * self._k, True, True, device, dtype,
                         base_sampler)

    @property
    def k(self):
        return self._k

    def _base_z_eps(self, generator, n_samples, dtype, device):
        """Base draws ``(z (n, k), eps (n, d))``; under a base sampler both
        blocks come from one joint ``(k + dim)``-wide draw."""
        if self._base_sampler is None:
            z = torch.randn((n_samples, self._k), generator=generator, dtype=dtype,
                            device=device)
            eps = torch.randn((n_samples, self.dim), generator=generator,
                              dtype=dtype, device=device)
            return z, eps
        joint = self._base_normal(generator, n_samples, self._k + self.dim, dtype,
                                  device)
        return joint[:, : self._k], joint[:, self._k:]

    def unpack(self, var_param):
        d, k = self.dim, self._k
        return var_param[:d], var_param[d: 2 * d], var_param[2 * d:].view(d, k)

    def init_param(self, generator=None):
        # mu = 0, log_sigma = 1, B ~ N(0, 1) (reference 628-632)
        if generator is None:
            generator = torch.Generator(self._device).manual_seed(1)
        d = self.dim
        B = torch.randn(d * self._k, generator=generator, dtype=self._dtype,
                        device=self._device)
        return torch.cat([self._zeros(d), 1.0 + self._zeros(d), B])

    def fold_affine(self, var_param, loc, scale):
        """Exact affine pushforward: ``mu' = loc + scale * mu``,
        ``log_sigma' = log_sigma + log scale``, ``B' = diag(scale) @ B``."""
        loc, scale = self._broadcast_affine(loc, scale)
        mu, log_sigma, B = self.unpack(var_param)
        return torch.cat([loc + scale * mu, log_sigma + torch.log(scale),
                          (scale[:, None] * B).reshape(-1)])

    def sample(self, var_param, n_samples, generator):
        mu, log_sigma, B = self.unpack(var_param)
        z, eps = self._base_z_eps(generator, n_samples, var_param.dtype,
                                  var_param.device)
        return mu + z @ B.T + torch.exp(log_sigma) * eps

    def sample_and_stl_log_density(self, var_param, n_samples, generator):
        """Fused STL: the score direction ``Sigma^{-1}(x - mu)`` under
        detached parameters through the Woodbury solve, attached to the
        samples only; no d x d factorisation."""
        mu, log_sigma, B = self.unpack(var_param)
        z, eps = self._base_z_eps(generator, n_samples, var_param.dtype,
                                  var_param.device)
        samples = mu + z @ B.T + torch.exp(log_sigma) * eps
        ls_s, B_s = log_sigma.detach(), B.detach()
        dev_s = (samples - mu).detach()                  # (n, d)
        sol = self._sigma_solve(ls_s, B_s, dev_s.T)      # (d, n)
        quad = torch.sum(dev_s.T * sol, dim=0)
        const = -0.5 * (self.dim * _LOG_2PI + self._logdet_sigma(ls_s, B_s) + quad)
        return samples, _STLAttach.apply(samples, sol.T, const)

    @staticmethod
    def _capacitance(log_sigma, B):
        """``C = I_k + B^T D^{-1} B`` with ``D = diag(exp(2 log_sigma))``."""
        D_inv = torch.exp(-2.0 * log_sigma)
        C = torch.eye(B.shape[1], dtype=B.dtype, device=B.device) + (B.T * D_inv) @ B
        return C, D_inv

    @staticmethod
    def _spd_solve(C, rhs):
        """``C^{-1} rhs`` by a Cholesky factor and two k x k triangular
        solves; ``rhs`` is ``(k, n)``."""
        Lc = torch.linalg.cholesky(C)
        y = torch.linalg.solve_triangular(Lc, rhs, upper=False)
        return torch.linalg.solve_triangular(Lc.T, y, upper=True)

    @classmethod
    def _logdet_sigma(cls, log_sigma, B):
        """``log det(B B^T + D)`` via the matrix-determinant lemma."""
        C, _ = cls._capacitance(log_sigma, B)
        Lc = torch.linalg.cholesky(C)
        return 2.0 * torch.sum(log_sigma) + 2.0 * torch.sum(torch.log(torch.diagonal(Lc)))

    @classmethod
    def _sigma_solve(cls, log_sigma, B, v):
        """``Sigma^{-1} v`` via Woodbury; ``v`` has shape ``(d,)`` or ``(d, n)``."""
        if v.dim() == 1:
            return cls._sigma_solve(log_sigma, B, v[:, None])[:, 0]
        C, D_inv = cls._capacitance(log_sigma, B)
        Dv = D_inv[:, None] * v
        w = cls._spd_solve(C, B.T @ Dv)
        return Dv - D_inv[:, None] * (B @ w)

    def _entropy(self, var_param):
        _, log_sigma, B = self.unpack(var_param)
        return 0.5 * self.dim * (_LOG_2PI + 1.0) + 0.5 * self._logdet_sigma(log_sigma, B)

    def _kl(self, var_param0, var_param1):
        mu0, ls0, B0 = self.unpack(var_param0)
        mu1, ls1, B1 = self.unpack(var_param1)
        logdet_diff = self._logdet_sigma(ls1, B1) - self._logdet_sigma(ls0, B0)
        dmu = mu0 - mu1
        maha = dmu @ self._sigma_solve(ls1, B1, dmu)
        # tr(Sigma1^{-1} Sigma0) = tr(Sigma1^{-1} B0 B0^T) + tr(Sigma1^{-1} D0)
        trace_lr = torch.sum(self._sigma_solve(ls1, B1, B0) * B0)
        # the diagonal of Sigma1^{-1} from the Woodbury form, never formed
        C1, D1_inv = self._capacitance(ls1, B1)
        W = self._spd_solve(C1, B1.T * D1_inv)  # (k, d)
        diag_S1inv = D1_inv - torch.sum((B1.T * D1_inv) * W, dim=0)
        trace_diag = torch.sum(diag_S1inv * torch.exp(2.0 * ls0))
        return 0.5 * (logdet_diff - self.dim + maha + trace_lr + trace_diag)

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        x = ensure_2d(x)
        mu, log_sigma, B = self.unpack(var_param)
        dev = x - mu  # (n, d)
        quad = torch.sum(dev.T * self._sigma_solve(log_sigma, B, dev.T), dim=0)
        out = -0.5 * (self.dim * _LOG_2PI + self._logdet_sigma(log_sigma, B) + quad)
        return out[0] if squeeze else out

    def mean_and_cov(self, var_param):
        mu, log_sigma, B = self.unpack(var_param)
        return mu, B @ B.T + torch.diag(torch.exp(2.0 * log_sigma))

    def _pth_moment(self, var_param, p):
        _, log_sigma, B = self.unpack(var_param)
        d_var = torch.exp(2.0 * log_sigma)
        trace = torch.sum(d_var) + torch.sum(B**2)
        if p == 2:
            return trace
        # ||Sigma||_F^2 = ||B^T B||_F^2 + 2 sum_i d_i ||B_i||^2 + sum_i d_i^2
        frob_sq = (torch.sum((B.T @ B) ** 2)
                   + 2.0 * torch.sum(d_var * torch.sum(B**2, dim=1))
                   + torch.sum(d_var**2))
        return 2.0 * frob_sq + trace**2

    def supports_pth_moment(self, p):
        return p in (2, 4)


def _mc_mean_and_cov(family, var_param, generator):
    """Mean and covariance of ``family.mc_samples`` draws (the reference's
    internal Monte Carlo, approximations.py:441-443); ``generator``
    defaults to seed 0 on the parameter's device."""
    if generator is None:
        generator = torch.Generator(var_param.device).manual_seed(0)
    samples = family.sample(var_param, family.mc_samples, generator)
    mean = torch.mean(samples, dim=0)
    centered = samples - mean
    return mean, centered.T @ centered / (samples.shape[0] - 1)


class NeuralNet(ApproximationFamily):
    """MLP pushforward of a standard normal (reference
    approximations.py:385-449): ``x = act(... act(z @ W_1 + b_1) ...)``,
    ``last`` on the final layer and ``nonlinearity`` on the others, both
    torch callables. ``log_density`` is not available (the map is in
    general not invertible); ``sample_and_log_density`` gives the exact
    density at the family's own samples when every layer is square, and
    ``mean_and_cov`` is estimated from ``mc_samples`` draws.
    """

    graph_safe = True

    def __init__(self, layers_shapes, nonlinearity=torch.tanh, last=torch.tanh,
                 mc_samples=10000, base_sampler=None, device="cuda", dtype=None):
        self._layers_shapes = [tuple(int(v) for v in s) for s in layers_shapes]
        self._nonlinearity = nonlinearity
        self._last = last
        self.mc_samples = int(mc_samples)
        self.input_dim = self._layers_shapes[0][0]
        n_params = sum(m * n + n for m, n in self._layers_shapes)
        super().__init__(self._layers_shapes[-1][-1], n_params, False, False,
                         device, dtype, base_sampler)

    def unpack(self, var_param):
        """The per-layer ``(W (m, n), b (n))`` pairs: views of one
        ``torch.split``, whose backward writes the gradient in one pass
        (a slice's backward would fill a zero vector of the whole
        parameter for each piece)."""
        sizes = [k for m, n in self._layers_shapes for k in (m * n, n)]
        pieces = torch.split(var_param, sizes)
        return [(pieces[2 * j].view(m, n), pieces[2 * j + 1])
                for j, (m, n) in enumerate(self._layers_shapes)]

    def forward(self, var_param, x):
        """Push ``x`` through the network. Like the JAX package, the
        reference's per-layer "log-det-Jacobian" (exact only for 1-D
        layers, and read by nothing) is not returned."""
        params = self.unpack(var_param)
        for idx, (W, b) in enumerate(params):
            act = self._last if idx + 1 == len(params) else self._nonlinearity
            x = act(x @ W + b)
        return x

    def sample(self, var_param, n_samples, generator):
        z0 = self._base_normal(generator, n_samples, self.input_dim,
                               var_param.dtype, var_param.device)
        return self.forward(var_param, z0)

    def log_density(self, var_param, x):
        raise NotImplementedError()

    def sample_and_log_density(self, var_param, n_samples, generator):
        """Samples and their exact pushforward log density, ``log q(x) =
        log N(z) - log |det J_f(z)|`` at the latent ``z`` each sample came
        from: one Jacobian a draw by ``torch.func.jacfwd`` under ``vmap``,
        then ``slogdet``. Needs every layer square (and the map injective
        on the support)."""
        d = self.input_dim
        if any(m != n for m, n in self._layers_shapes):
            raise ValueError("exact pushforward density needs square layers")
        z0 = self._base_normal(generator, n_samples, d, var_param.dtype,
                               var_param.device)
        x = self.forward(var_param, z0)

        def single(z):
            return self.forward(var_param, z[None, :])[0]

        jac = func.vmap(func.jacfwd(single))(z0)          # (n, d, d)
        _, logdet = torch.linalg.slogdet(jac)
        log_p_z = torch.sum(-0.5 * z0**2 - 0.5 * _LOG_2PI, dim=-1)
        return x, log_p_z - logdet

    def mean_and_cov(self, var_param, generator=None):
        return _mc_mean_and_cov(self, var_param, generator)

    def supports_pth_moment(self, p):
        return False


class NVPFlow(ApproximationFamily):
    """RealNVP masked affine coupling flow (reference
    approximations.py:452-550). The ``t`` and ``s`` subnetworks are
    :class:`NeuralNet` MLPs (identity and tanh last activations); the
    exact log density uses the coupling log-determinant ``-sum(s)``. The
    base distribution is any family of the port, ``prior`` at
    ``prior_param``; the flow lives on the prior's device and in its
    dtype. ``mask`` holds one 0/1 row a coupling; it is cast to the
    parameter's dtype where it is used.

    :meth:`init_param` is all zeros, as in the JAX package. From there only
    the output biases ever move: every hidden activation and every output
    matrix is zero, so the gradients of the hidden layers and of the
    output matrices are exactly zero and stay so. Fit from
    :class:`RealNVP`'s start, or pass an ``init_var_param`` whose layers
    are not all zero."""

    graph_safe = True

    def graph_refusal(self):
        return super().graph_refusal() or self.prior.graph_refusal()

    def __init__(self, layers_t, layers_s, mask, prior, prior_param, dim,
                 activation=torch.tanh, mc_samples=10000):
        if len(layers_t) != len(layers_s):
            raise ValueError("layers_t and layers_s need one entry per layer each")
        device, dtype = prior.device, prior.dtype
        self.prior = prior
        self.prior_param = torch.as_tensor(prior_param, dtype=dtype, device=device)
        self.mask = torch.as_tensor(mask, device=device)
        self.mc_samples = int(mc_samples)
        net = dict(device=device, dtype=dtype)
        self.t_net = NeuralNet(layers_t, nonlinearity=activation, last=lambda x: x, **net)
        self.s_net = NeuralNet(layers_s, nonlinearity=activation, last=torch.tanh, **net)
        self._n_coupling = int(self.mask.shape[0])
        per_layer = self.t_net.var_param_dim + self.s_net.var_param_dim
        super().__init__(dim, self._n_coupling * per_layer, False, False, device, dtype)

    def unpack(self, var_param):
        """The per-coupling ``(t_params, s_params)`` flat vectors, views of
        one ``torch.split`` (see :meth:`NeuralNet.unpack`)."""
        pieces = torch.split(var_param, [self.t_net.var_param_dim,
                                         self.s_net.var_param_dim] * self._n_coupling)
        return list(zip(pieces[0::2], pieces[1::2]))

    def _masks(self, var_param):
        return self.mask.to(dtype=var_param.dtype)

    def g(self, var_param, z):
        """Inverse flow, latent to data (reference 494-511)."""
        with span("viabel.flow.sample"):
            x, masks = z, self._masks(var_param)
            for i, (tp, sp) in enumerate(self.unpack(var_param)):
                m = masks[i]
                x_masked = x * m
                s = self.s_net.forward(sp, x_masked) * (1.0 - m)
                t = self.t_net.forward(tp, x_masked) * (1.0 - m)
                x = x_masked + (1.0 - m) * (x * torch.exp(s) + t)
            return x

    def f(self, var_param, x):
        """Forward flow, data to latent, with ``log |det J|`` (reference
        513-531)."""
        with span("viabel.flow.log_density"):
            z, masks = x, self._masks(var_param)
            log_det_J = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            params = self.unpack(var_param)
            for i in reversed(range(self._n_coupling)):
                tp, sp = params[i]
                m = masks[i]
                z_masked = m * z
                s = self.s_net.forward(sp, z_masked) * (1.0 - m)
                t = self.t_net.forward(tp, z_masked) * (1.0 - m)
                z = (1.0 - m) * (z - t) * torch.exp(-s) + z_masked
                log_det_J = log_det_J - torch.sum(s, dim=1)
            return z, log_det_J

    def log_density(self, var_param, x):
        squeeze = x.dim() == 1
        z, logdet = self.f(var_param, ensure_2d(x))
        out = self.prior.log_density(self.prior_param, z) + logdet
        return out[0] if squeeze else out

    def sample(self, var_param, n_samples, generator):
        z0 = self.prior.sample(self.prior_param, int(n_samples), generator)
        return self.g(var_param, z0)

    def mean_and_cov(self, var_param, generator=None):
        return _mc_mean_and_cov(self, var_param, generator)

    def supports_pth_moment(self, p):
        return False


class RealNVP(NVPFlow):
    """RealNVP (Dinh, Sohl-Dickstein & Bengio, ICLR 2017) as an
    :class:`NVPFlow` built from the dimension alone, with a start that
    trains every layer.

    ``n_couplings`` affine couplings alternate halves: coupling ``i``
    conditions on the first ``dim // 2`` coordinates when ``i`` is even and
    on the rest when it is odd. Its ``t`` and ``s`` nets are
    :class:`NeuralNet` MLPs of shapes ``(dim, hidden[0]), ...,
    (hidden[-1], dim)``, with ``activation`` between layers (``s`` ends in
    tanh, ``t`` in the identity). The base is a standard normal
    (:class:`MFGaussian` at zero parameters).

    :meth:`init_param` is the identity map with live hidden layers: every
    hidden layer's ``W`` is ``randn(m, n) / sqrt(m)`` and its ``b`` zero,
    every last layer's ``W`` and ``b`` zero, so q starts as the base and
    every layer has a gradient by the second step. The draws come from a
    CPU ``torch.Generator`` seeded with ``init_seed``, in float64, coupling
    by coupling, ``t`` before ``s``, layer by layer; the parameters are then
    moved to the family's device and dtype. The start is drawn once and
    each call returns a copy of it.
    """

    graph_safe = True

    def __init__(self, dim, n_couplings=4, hidden=(512, 512), init_seed=0,
                 activation=torch.tanh, mc_samples=10000, device="cuda", dtype=None):
        dim, n_couplings = int(dim), int(n_couplings)
        if dim < 2 or n_couplings < 1:
            raise ValueError("RealNVP needs dim >= 2 and n_couplings >= 1")
        widths = [dim, *(int(h) for h in hidden), dim]
        shapes = list(zip(widths[:-1], widths[1:]))
        prior = MFGaussian(dim, device=device, dtype=dtype)
        first = torch.arange(dim) < dim // 2
        mask = torch.stack([first if i % 2 == 0 else ~first for i in range(n_couplings)])
        self.init_seed = int(init_seed)
        self._start = None
        super().__init__(shapes, shapes, mask.to(prior.dtype), prior, prior._zeros(2 * dim),
                         dim, activation=activation, mc_samples=mc_samples)

    def init_param(self):
        if self._start is None:
            self._start = self._draw_start()
        return self._start.clone()

    def _draw_start(self):
        gen = torch.Generator().manual_seed(self.init_seed)
        shapes = self.t_net._layers_shapes
        parts = []
        for _ in range(self._n_coupling):
            for _net in ("t", "s"):
                for idx, (m, n) in enumerate(shapes):
                    if idx + 1 < len(shapes):
                        W = torch.randn(m, n, generator=gen, dtype=torch.float64) / math.sqrt(m)
                    else:
                        W = torch.zeros(m, n, dtype=torch.float64)
                    parts += [W.reshape(-1), torch.zeros(n, dtype=torch.float64)]
        return torch.cat(parts).to(device=self.device, dtype=self.dtype)
