"""Variational objectives (counterpart of ``viabel_tpu/objectives.py``).

Each objective exposes ``value_and_grad(var_param, generator) -> (value,
grad)``: one Monte Carlo loss evaluation and its gradient by
``torch.autograd``, both from the same draws. The generator replaces the
JAX package's explicit PRNG key.

- ``ExclusiveKL``: the negative ELBO, by the entropy form, the "sticking
  the landing" path derivative, or the Miller et al. (2017)
  control-variate estimators (``hessian_approx_method``), whose
  Hessian-vector products of the model come from ``torch.func``.
- ``IWELBO``: the importance-weighted bound, with the doubly
  reparameterized gradient by default.
- ``AlphaDivergence``: the CUBO objective with the reference's
  gradient ``alpha J^T w^alpha / S``.
"""

import math

import torch
from torch import func

from .utils import deferred_names

__all__ = ["VariationalObjective", "StochasticVariationalObjective",
           "ExclusiveKL", "IWELBO", "AlphaDivergence"]

#: objectives of the JAX package not ported yet, by ROADMAP.md item
NOT_PORTED = {"DISInclusiveKL": "9b"}
__getattr__ = deferred_names(__name__, NOT_PORTED)

_HESSIAN_METHODS = (None, "full", "mean_only", "loo_diag_approx", "loo_direct_approx")


class VariationalObjective:
    """A variational objective to minimize."""

    def __init__(self, approx, model):
        self._approx = approx
        self._model = model

    def _loss(self, var_param, generator):
        raise NotImplementedError()

    def value_and_grad(self, var_param, generator):
        """The (stochastic) objective value and its gradient."""
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._loss(vp, generator)
            (grad,) = torch.autograd.grad(loss, vp)
        return loss.detach(), grad

    def update(self, var_param, direction):
        """Apply a descent step."""
        return var_param - direction

    @property
    def approx(self):
        return self._approx

    @property
    def model(self):
        return self._model


class StochasticVariationalObjective(VariationalObjective):
    """Adds the Monte Carlo sample count."""

    def __init__(self, approx, model, num_mc_samples):
        self._num_mc_samples = int(num_mc_samples)
        super().__init__(approx, model)

    @property
    def num_mc_samples(self):
        return self._num_mc_samples

    @num_mc_samples.setter
    def num_mc_samples(self, value):
        self._num_mc_samples = int(value)

    def set_num_mc_samples(self, value):
        """Change the Monte Carlo sample count mid-run (the API behind
        ``FASO(mc_escalation=...)``'s rung climbs); it takes effect at the
        next step."""
        self.num_mc_samples = int(value)


class ExclusiveKL(StochasticVariationalObjective):
    """Exclusive KL / negative ELBO.

    Parameters
    ----------
    use_path_deriv : bool
        "Sticking the landing" path-derivative estimator.
    hessian_approx_method : str or None
        One of ``full``, ``mean_only``, ``loo_diag_approx``,
        ``loo_direct_approx``: the Miller et al. (2017) control-variate
        estimators, for a mean-field family (one with
        ``mean_and_stdevs``). They differentiate the model with
        ``torch.func`` (a ``jvp`` of its ``grad``, under ``vmap`` over the
        draws), so the model must be a pure function of its input that
        ``torch.func`` can transform; one that is not raises a
        ``RuntimeError`` naming the cause.
    """

    def __init__(self, approx, model, num_mc_samples, use_path_deriv=False,
                 hessian_approx_method=None):
        if hessian_approx_method not in _HESSIAN_METHODS:
            raise ValueError(
                "hessian_approx_method must be one of 'full', 'mean_only', "
                "'loo_diag_approx', 'loo_direct_approx', or None")
        if hessian_approx_method is not None and not hasattr(approx,
                                                             "mean_and_stdevs"):
            raise ValueError(
                "the Hessian control-variate estimators require a "
                "mean-field [mu, log_sigma] family (one providing "
                "mean_and_stdevs), e.g. MFGaussian")
        self.hessian_approx_method = hessian_approx_method
        self._use_path_deriv = bool(use_path_deriv)
        super().__init__(approx, model, num_mc_samples)

    def _loss(self, var_param, generator, num_samples=None):
        approx, model = self.approx, self.model
        n = num_samples or self.num_mc_samples
        if self._use_path_deriv:
            samples, log_q = approx.sample_and_stl_log_density(var_param, n,
                                                               generator)
            return -torch.mean(model(samples) - log_q)
        if approx.supports_entropy:
            samples, entropy = approx.sample_and_entropy(var_param, n, generator)
            lower_bound = torch.mean(model(samples)) + entropy
        else:
            samples = approx.sample(var_param, n, generator)
            lower_bound = torch.mean(model(samples)
                                     - approx.log_density(var_param, samples))
        return -lower_bound

    def value_and_grad(self, var_param, generator):
        """With ``hessian_approx_method`` set: the Miller et al.
        control-variate gradient (the JAX package's objectives.py:255-323,
        from reference objectives.py:170-273) and the loss at the same
        draws."""
        if self.hessian_approx_method is None:
            return super().value_and_grad(var_param, generator)
        approx, model = self.approx, self.model
        S = self.num_mc_samples
        var_param = var_param.detach()
        z_samples = approx.sample(var_param, S, generator)
        m_mean, s_scale = approx.mean_and_stdevs(var_param)
        eps = (z_samples - m_mean) / s_scale
        if self._use_path_deriv or not approx.supports_entropy:
            lower_bound = torch.mean(model(z_samples)
                                     - approx.log_density(var_param, z_samples))
        else:
            lower_bound = torch.mean(model(z_samples)) + approx.entropy(var_param)
        try:
            g_rv = _control_variate_grad(model, self.hessian_approx_method, S,
                                         z_samples, m_mean, s_scale, eps)
        except RuntimeError as exc:
            raise RuntimeError(
                "ExclusiveKL(hessian_approx_method=...) takes Hessian-vector "
                "products of the model with torch.func (jvp of grad under "
                "vmap), and this model could not be transformed; it must be "
                "written in torch operations on its input alone (no numpy, no "
                f"reads of the tensor's data on the host): {exc}"
            ) from exc
        return -lower_bound, -g_rv

    def hessian_vector_product(self, var_param, x, generator):
        """HVP of the plain objective at one draw of the generator (reverse
        over reverse: the gradient with its graph, then its product with
        ``x``)."""
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self._loss(vp, generator), vp,
                                       create_graph=True)
            (hvp,) = torch.autograd.grad(g, vp, grad_outputs=x)
        return hvp


def _control_variate_grad(model, method, S, z_samples, m_mean, s_scale, eps):
    """The variance-reduced ELBO gradient in the ``[mu | log_sigma]``
    layout, by ``method``."""

    def f_single(x):
        return model(x[None, :])[0]

    grad_single = func.grad(f_single)

    def hvp_at_mean(v):
        return func.jvp(grad_single, (m_mean,), (v,))[1]

    # raw reparameterization gradient samples
    dLdm = func.grad(lambda z: torch.sum(model(z)))(z_samples)  # (S, d)
    dLdlns = dLdm * eps * s_scale + 1.0                         # (S, d)
    if method == "full":
        # reference objectives.py:200-216
        gmu = grad_single(m_mean)
        H = func.hessian(f_single)(m_mean)
        Hdiag = torch.diagonal(H)
        dLdz = gmu + (s_scale * eps) @ H.T
        dLds = dLdz * eps * s_scale + 1.0
        tilde = torch.cat([dLdz, dLds], dim=1)
        tilde_mean = torch.cat([gmu, (Hdiag * s_scale + 1.0 / s_scale) * s_scale])
        g_hat = torch.cat([dLdm, dLdlns], dim=1)
        return torch.mean(g_hat - (tilde - tilde_mean), dim=0)
    hvps = func.vmap(hvp_at_mean)(s_scale * eps)  # (S, d)
    if method == "mean_only":
        # reference objectives.py:217-233: tilde - E[tilde] = [hvps, 0]
        return torch.cat([torch.mean(dLdm - hvps, dim=0), torch.mean(dLdlns, dim=0)])
    dLdz = grad_single(m_mean) + hvps
    if method == "loo_diag_approx":
        # reference objectives.py:234-255
        dLds = dLdz * (eps * s_scale) + 1.0
        Hdiag_sum = torch.sum(eps * hvps, dim=0)
        Hdiag_s = (Hdiag_sum[None, :] - eps * hvps) / float(S - 1)
        dLds_mu = (Hdiag_s + 1.0 / s_scale[None, :]) * s_scale
        return torch.cat([torch.mean(dLdm - hvps, dim=0),
                          torch.mean(dLdlns - (dLds - dLds_mu), dim=0)])
    # loo_direct_approx, reference objectives.py:256-268
    dLds = (dLdz * eps + 1.0 / s_scale[None, :]) * s_scale
    dLds_mu = (torch.sum(dLds, dim=0)[None, :] - dLds) / float(S - 1)
    g_hat = torch.cat([dLdm, dLdlns], dim=1)
    return torch.mean(g_hat - torch.cat([hvps, dLds - dLds_mu], dim=1), dim=0)


class IWELBO(StochasticVariationalObjective):
    """Importance-weighted ELBO, the IWAE bound (Burda et al. 2016):
    minimises ``-log (1/S) sum_i w_i`` with ``w_i = p(x_i)/q(x_i)``.

    The gradient is by default the doubly reparameterized (DReG) estimator
    (Tucker et al. 2019): ``log q`` at detached parameters through the
    families' ``sample_and_stl_log_density`` hook (the STL solve kernel on
    a Cholesky family), reweighted by the squared normalised weights and
    attached through a zero-valued surrogate. At ``S = 1`` it is the STL
    ELBO gradient. ``use_dreg=False`` gives the plain IWAE gradient.
    """

    def __init__(self, approx, model, num_mc_samples, use_dreg=True):
        self._use_dreg = bool(use_dreg)
        super().__init__(approx, model, num_mc_samples)

    def _loss(self, var_param, generator, num_samples=None):
        approx, model = self.approx, self.model
        n = num_samples or self.num_mc_samples
        if self._use_dreg:
            samples, log_q = approx.sample_and_stl_log_density(var_param, n,
                                                               generator)
            lw = model(samples) - log_q          # score path already detached
            lw_s = lw.detach()
            w_hat = torch.softmax(lw_s, dim=0)
            # the value is the bound; the gradient sum_i w_hat_i^2 dlw_i
            # through the reparameterized path (Tucker et al. 2019, eq. 12)
            surrogate = torch.sum(w_hat * w_hat * lw)
            value = torch.logsumexp(lw_s, dim=0) - math.log(n)
            return -(value + surrogate - surrogate.detach())
        samples = approx.sample(var_param, n, generator)
        lw = model(samples) - approx.log_density(var_param, samples)
        return -(torch.logsumexp(lw, dim=0) - math.log(n))


class AlphaDivergence(StochasticVariationalObjective):
    """Log alpha-divergence / CUBO objective (reference objectives.py:419-463).

    The value is ``log mean(w^alpha) / alpha`` of the log weights ``log p -
    log q``, stabilised by their maximum. The gradient follows the
    reference, ``alpha J^T w^alpha / S`` with ``J`` the Jacobian of the log
    weights: a positive rescaling of the exact CUBO gradient (the
    ``1/mean(w^alpha)`` normaliser is dropped, reference objectives.py:460).
    On a Cholesky family, ``log q`` and its gradient run the triangular
    solve kernel forward and in its adjoint.
    """

    def __init__(self, approx, model, num_mc_samples, alpha):
        self._alpha = float(alpha)
        super().__init__(approx, model, num_mc_samples)

    @property
    def alpha(self):
        return self._alpha

    def value_and_grad(self, var_param, generator):
        approx, model = self.approx, self.model
        S, alpha = self.num_mc_samples, self._alpha
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            samples = approx.sample(vp, S, generator)
            log_weights = model(samples) - approx.log_density(vp, samples)
            lw = log_weights.detach()
            log_norm = torch.max(lw)
            scaled = torch.exp(alpha * (lw - log_norm))
            (jtw,) = torch.autograd.grad(log_weights, vp, grad_outputs=scaled)
        value = torch.log(torch.mean(scaled)) / alpha + log_norm
        return value, alpha * jtw / S
