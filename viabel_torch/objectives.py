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
- ``DISInclusiveKL``: the inclusive KL by distilled importance sampling,
  the one objective that carries state between steps.

Objective-state protocol: an objective whose estimator carries state
between steps exposes it as a dict of tensors, ``init_obj_state`` /
``value_and_grad_with_state(var_param, generator, obj_state) -> (value,
grad, obj_state)``, and the optimizers thread it through their loops
(``check_obj_state`` at segment boundaries, ``resize_obj_state`` when
FASO's escalation changes the sample count). A stateless objective has
the empty state ``{}``.

MC-sample-axis data parallelism: ``ExclusiveKL``, ``IWELBO`` and
``AlphaDivergence`` have ``mc_sharded_step(mesh, axis_name)``, and DIS
(without resampling) ``mc_sharded_step_with_state``: the per-rank step
of :func:`viabel_torch.parallel.shard_mc_objective`. Each rank draws
``S / n`` samples from a generator derived from the caller's generator and
its mesh coordinate, and the reductions that couple the samples are
``torch.distributed`` all-reduces on detached tensors.

A model that draws its own minibatch (``needs_generator``, e.g.
:class:`~viabel_torch.models.SubsampledModel`) is bound once a step, before
the family's draw (:func:`_step_model`), so every evaluation in the step
sees one minibatch; the importance-weight objectives refuse such a model.
"""

import math

import torch
from torch import func

from .tracing import span
from .utils import GraphSafety

__all__ = ["VariationalObjective", "StochasticVariationalObjective",
           "ExclusiveKL", "IWELBO", "AlphaDivergence", "DISInclusiveKL"]

_HESSIAN_METHODS = (None, "full", "mean_only", "loo_diag_approx", "loo_direct_approx")


def _step_model(model, generator):
    """The model for one objective step. A model that draws its own
    randomness (``needs_generator``) draws it here, once, from the step's
    generator, and the returned callable evaluates every sample batch of
    the step on that draw (the JAX package splits the step key once for
    the same purpose, objectives.py:55-69). Any other model is returned
    as it is, and the generator's stream is left untouched."""
    if getattr(model, "needs_generator", False):
        return model.bind(generator)
    return model


def _reject_subsampled(model, objective_name):
    """Importance-weight objectives need exact log densities: weights
    ``exp(log p - log q)`` of a noisy (subsampled) model estimate are
    biased (``E[exp(noisy)] != exp(E[noisy])``), unlike the ELBO, which is
    linear in ``log p``."""
    if getattr(model, "needs_generator", False):
        raise ValueError(
            f"{objective_name} requires an exact log density: importance "
            "weights of a subsampled model estimate are biased — use "
            "ExclusiveKL for SubsampledModel")


def _ShardAxis(mesh, axis_name):
    """One mesh axis of MC-sample data parallelism, seen from this rank
    (:class:`viabel_torch.parallel.mesh.MeshAxis`; imported here at call
    time, since the parallel package imports this module)."""
    from .parallel.mesh import MeshAxis
    return MeshAxis(mesh, axis_name)


class VariationalObjective(GraphSafety):
    """A variational objective to minimize.

    Whether a CUDA graph may replay its steps (:class:`GraphSafety`): the
    objective's own statement, then its family's and its model's. A model
    that is a plain callable, not a :class:`~viabel_torch.models.Model`,
    is replayed as ``jax.jit`` would trace it.
    """

    def __init__(self, approx, model):
        self._check_model(model)
        self._approx = approx
        self._model = model

    def _check_model(self, model):
        """Refuse a model the estimator cannot use (a no-op here)."""

    def _loss(self, var_param, generator):
        raise NotImplementedError()

    def graph_refusal(self):
        refusal = super().graph_refusal() or self.approx.graph_refusal()
        if refusal is None and isinstance(self.model, GraphSafety):
            refusal = self.model.graph_refusal()
        return refusal

    def value_and_grad(self, var_param, generator):
        """The (stochastic) objective value and its gradient."""
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            with span("viabel.step.loss"):
                loss = self._loss(vp, generator)
            with span("viabel.step.grad"):
                (grad,) = torch.autograd.grad(loss, vp)
        return loss.detach(), grad

    def update(self, var_param, direction):
        """Apply a descent step."""
        return var_param - direction

    # -- objective-state protocol --------------------------------------------
    def init_obj_state(self, var_param):
        """Initial estimator state carried through the optimizer loop
        (``{}`` for a stateless objective)."""
        return {}

    def value_and_grad_with_state(self, var_param, generator, obj_state):
        """One step: ``(var_param, generator, state) -> (value, grad,
        state)``."""
        value, grad = self.value_and_grad(var_param, generator)
        return value, grad, obj_state

    def check_obj_state(self, obj_state):
        """Host-side validity hook, called at segment boundaries and at the
        end of a run; raises if the loop recorded a failure."""

    def resize_obj_state(self, obj_state, var_param):
        """The state after a ``num_mc_samples`` change (FASO's
        ``mc_escalation`` rung boundary): a fresh one by default."""
        return self.init_obj_state(var_param)

    @property
    def approx(self):
        return self._approx

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, value):
        # the objectives read the model at every step and cache nothing
        # derived from it, so swapping it is all a rebind needs
        self._check_model(value)
        self._model = value


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
        next step. An optimizer threading estimator state re-derives it
        with :meth:`resize_obj_state` (FASO's escalation does)."""
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

    graph_safe = True

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

    def graph_refusal(self):
        if self.hessian_approx_method is not None:
            return "the control-variate gradient (hessian_approx_method)"
        return super().graph_refusal()

    def _loss(self, var_param, generator, num_samples=None):
        approx = self.approx
        model = _step_model(self.model, generator)
        n = num_samples or self.num_mc_samples
        if self._use_path_deriv:
            samples, log_q = approx.sample_and_stl_log_density(var_param, n,
                                                               generator)
            return -torch.mean(model(samples) - log_q)
        if approx.supports_entropy:
            samples, entropy = approx.sample_and_entropy(var_param, n, generator)
            lower_bound = torch.mean(model(samples)) + entropy
        elif hasattr(approx, "sample_and_log_density"):
            # families whose density is only tractable at their own samples
            # (square NeuralNet pushforwards)
            samples, log_q = approx.sample_and_log_density(var_param, n, generator)
            lower_bound = torch.mean(model(samples) - log_q)
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
        approx = self.approx
        model = _step_model(self.model, generator)
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

    def mc_sharded_step(self, mesh, axis_name="mc"):
        """The per-rank step of MC-sample data parallelism over
        ``mesh``'s axis ``axis_name`` (the JAX package's
        objectives.py:334-360): ``step(var_param, generator) -> (value,
        grad)``. Each rank draws ``S / n`` samples (its own generator,
        :meth:`_ShardAxis.generator`), evaluates its value and gradient,
        and one all-reduce averages both; STL on a Cholesky family runs
        kernel 2 as the unsharded step does. ``S`` is read at every step
        and must divide."""
        if self.hessian_approx_method is not None:
            raise ValueError("the Hessian control-variate estimators do not support "
                             "MC-axis sharding")
        axis = _ShardAxis(mesh, axis_name)
        axis.local_count(self.num_mc_samples)

        def step(var_param, generator):
            local_S = axis.local_count(self.num_mc_samples)
            g = axis.generator(generator)
            vp = var_param.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = self._loss(vp, g, num_samples=local_S)
                (grad,) = torch.autograd.grad(loss, vp)
            packed = axis.sum(torch.cat([loss.detach().reshape(1), grad])) / axis.n
            return packed[0], packed[1:]

        return step

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

    graph_safe = True

    def __init__(self, approx, model, num_mc_samples, use_dreg=True):
        self._use_dreg = bool(use_dreg)
        super().__init__(approx, model, num_mc_samples)

    def _check_model(self, model):
        _reject_subsampled(model, "IWELBO")

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

    def mc_sharded_step(self, mesh, axis_name="mc"):
        """The per-rank step of MC-sample data parallelism (the JAX
        package's objectives.py:417-465; see
        :meth:`ExclusiveKL.mc_sharded_step`). The bound couples every
        sample through one log-sum-exp: the stabilizing max is an
        all-reduce MAX and the normalizer a SUM, both of detached
        values; the local surrogate re-attaches this rank's terms of the
        gradient, and the gradients are SUM-reduced. DReG and plain."""
        axis = _ShardAxis(mesh, axis_name)
        axis.local_count(self.num_mc_samples)

        def step(var_param, generator):
            S = self.num_mc_samples
            local_S = axis.local_count(S)
            g = axis.generator(generator)
            approx, model = self.approx, self.model
            vp = var_param.detach().requires_grad_(True)
            with torch.enable_grad():
                if self._use_dreg:
                    samples, log_q = approx.sample_and_stl_log_density(vp, local_S, g)
                    lw = model(samples) - log_q
                else:
                    samples = approx.sample(vp, local_S, g)
                    lw = model(samples) - approx.log_density(vp, samples)
                lw_s = lw.detach()
                m = axis.max(torch.max(lw_s))
                w = torch.exp(lw_s - m)
                norm = axis.sum(torch.sum(w))
                value = torch.log(norm) + m - math.log(S)
                w_hat = w / norm
                surrogate = torch.sum((w_hat * w_hat if self._use_dreg else w_hat) * lw)
                loss = -(value + surrogate - surrogate.detach())
                (grad,) = torch.autograd.grad(loss, vp)
            return loss.detach(), axis.sum(grad)

        return step


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

    graph_safe = True

    def __init__(self, approx, model, num_mc_samples, alpha):
        self._alpha = float(alpha)
        super().__init__(approx, model, num_mc_samples)

    def _check_model(self, model):
        _reject_subsampled(model, "AlphaDivergence")

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

    def mc_sharded_step(self, mesh, axis_name="mc"):
        """The per-rank step of MC-sample data parallelism (the JAX
        package's objectives.py:504-539): the MAX of the local maxima
        scales every rank's weights alike, and one SUM carries the local
        weight means (their mean is the value's) and the local
        vector-Jacobian products (their sum over ``S`` is the
        gradient)."""
        axis = _ShardAxis(mesh, axis_name)
        axis.local_count(self.num_mc_samples)

        def step(var_param, generator):
            approx, model = self.approx, self.model
            S, alpha = self.num_mc_samples, self._alpha
            local_S = axis.local_count(S)
            g = axis.generator(generator)
            vp = var_param.detach().requires_grad_(True)
            with torch.enable_grad():
                samples = approx.sample(vp, local_S, g)
                log_weights = model(samples) - approx.log_density(vp, samples)
                lw = log_weights.detach()
                log_norm = axis.max(torch.max(lw))
                scaled = torch.exp(alpha * (lw - log_norm))
                (jtw,) = torch.autograd.grad(log_weights, vp, grad_outputs=scaled)
            packed = axis.sum(torch.cat([torch.mean(scaled).reshape(1), jtw]))
            value = torch.log(packed[0] / axis.n) / alpha + log_norm
            return value, alpha * packed[1:] / S

        return step


class _MultinomialResampler:
    """The default resampling draw: ``n`` indices with replacement, with
    probabilities ``p``, from the generator."""

    @staticmethod
    def choice(generator, p, n):
        return torch.multinomial(p, n, replacement=True, generator=generator)


class DISInclusiveKL(StochasticVariationalObjective):
    """Inclusive KL by distilled importance sampling (reference
    objectives.py:280-416; the JAX package's objectives.py:542-907).

    The estimator carries its tempering ``eps``, a degeneracy flag ``ok``,
    a step counter and, with resampling, the cache of the last refresh
    (``samples``, ``w_norm``, ``w_sum``) from step to step, as the dict of
    the objective-state protocol. The counter ``step`` is a CPU tensor, so
    the refresh every ``num_resampling_batches`` steps is decided on the
    host without a device synchronisation; everything else lives on the
    parameter's device, and the 50-step bisection on ``eps`` runs there
    through ``torch.where`` on 0-d tensors.

    Like the JAX package, the weights are self-normalised (see
    :meth:`_weights`) and degenerate weights are recorded in ``ok`` and
    raised by :meth:`check_obj_state` at the next segment boundary.

    ``resampler``: the hook that draws the resampling indices, an object
    with ``choice(generator, p, n) -> (n,) index tensor``; the default is
    ``torch.multinomial`` with replacement. The JAX package draws with
    ``jax.random.choice``, whose stream torch cannot reproduce, so a test
    injects the indices here, as it injects base draws through a family's
    ``base_sampler``.
    """

    #: its state is threaded between steps, and the refresh is chosen on
    #: the host
    graph_safe = False

    def __init__(self, approx, model, num_mc_samples, ess_target,
                 temper_prior, temper_prior_params, use_resampling=True,
                 num_resampling_batches=1, w_clip_threshold=10, resampler=None):
        self._ess_target = float(ess_target)
        self._w_clip_threshold = float(w_clip_threshold)
        self._max_bisection_its = 50
        self._max_eps = 1.0
        self._use_resampling = bool(use_resampling)
        self._num_resampling_batches = int(num_resampling_batches)
        self._resampling_batch_size = max(1, int(ess_target) // int(num_resampling_batches))
        self._resampler = resampler or _MultinomialResampler()
        self._obj_state = None  # mirror for direct value_and_grad calls
        self._temper_prior = temper_prior
        self._temper_prior_params = torch.as_tensor(
            temper_prior_params, dtype=temper_prior.dtype, device=temper_prior.device)
        super().__init__(approx, model, num_mc_samples)

    def _check_model(self, model):
        _reject_subsampled(model, "DISInclusiveKL")

    @property
    def num_mc_samples(self):
        return self._num_mc_samples

    @num_mc_samples.setter
    def num_mc_samples(self, value):
        self._num_mc_samples = int(value)
        # the mirrored state holds old-S shapes
        self._obj_state = None

    # -- the estimator's parts ------------------------------------------------
    def _temper_log_density(self, samples):
        return self._temper_prior.log_density(self._temper_prior_params, samples)

    def _tempered_log_pdf(self, eps, samples, log_p, ltp=None):
        if ltp is None:
            ltp = self._temper_log_density(samples)
        return eps * ltp + (1.0 - eps) * log_p

    def _weights(self, eps, samples, log_p, log_q, ltp=None, axis=None):
        """Self-normalised importance weights ``exp(logw - max logw)``.

        A deliberate departure from the reference (objectives.py:322-331),
        kept from the JAX package: the raw ``exp(logw)`` of an
        unnormalised target underflows to all zeros in float32 already at
        d ~ 100. ESS and proportional clipping are scale-invariant, so the
        bisection visits the same ``eps`` sequence. With ``axis`` (a
        sharded sample axis) the max is all-reduced, so every rank's
        weights share one scale.
        """
        logw = self._tempered_log_pdf(eps, samples, log_p, ltp) - log_q
        m = torch.max(logw)
        if axis is not None:
            m = axis.max(m)
        return torch.exp(logw - m)

    def _eps_and_weights(self, eps_guess, samples, log_p, log_q, axis=None):
        """Bisection on ``eps`` to hit the ESS target (reference 338-368):
        ``(eps, ess, weights)``, all on the device. With ``axis`` the ESS
        sums are all-reduced (one SUM of the pair a bisection step, beside
        the weights' MAX), so a sharded step visits the same ``eps``
        sequence as an unsharded step on the concatenated samples."""
        ltp = self._temper_log_density(samples)

        def ess_of(w):
            sums = torch.stack([torch.sum(w), torch.sum(w**2)])
            if axis is not None:
                sums = axis.sum(sums)
            return sums[0] ** 2 / sums[1]

        lower = torch.zeros((), dtype=log_q.dtype, device=log_q.device)
        upper = torch.as_tensor(eps_guess, dtype=log_q.dtype, device=log_q.device)
        guess = (lower + upper) / 2.0
        for _ in range(self._max_bisection_its):
            w = self._weights(guess, samples, log_p, log_q, ltp, axis)
            too_big = ess_of(w) > self._ess_target
            upper = torch.where(too_big, guess, upper)
            lower = torch.where(too_big, lower, guess)
            guess = (lower + upper) / 2.0
        # endpoint handling (reference objectives.py:362-366)
        guess = torch.where(lower == 0.0, 0.0, guess)
        guess = torch.where(upper == self._max_eps, self._max_eps, guess)
        w = self._weights(guess, samples, log_p, log_q, ltp, axis)
        return guess, ess_of(w), w

    def _clip_weights(self, w, axis=None):
        """Proportional weight clipping (the corrected form of reference
        370-386): no weight exceeds ``threshold`` times the total, the
        clipped mass goes to the unclipped weights in proportion, and the
        total is kept; 16 passes. A no-op for ``threshold >= 1`` (the
        default, 10). With ``axis`` the totals are all-reduced."""
        tau = self._w_clip_threshold
        n = self.num_mc_samples if axis is not None else w.shape[0]
        if tau >= 1.0 or tau * n <= 1.0:
            return w

        def gsum(*xs):
            sums = torch.stack([torch.sum(x) for x in xs])
            return axis.sum(sums) if axis is not None else sums

        total = gsum(w)[0]
        p = w / total
        for _ in range(16):
            over = p > tau
            excess, keep = gsum(torch.where(over, p - tau, 0.0), torch.where(over, 0.0, p))
            scale = torch.where(keep > 0, 1.0 + excess / keep, 1.0)
            p = torch.where(over, tau, p * scale)
        return p * total

    def _refresh(self, var_param, generator, eps_guess, num_samples=None, axis=None):
        """Draw samples, bisect ``eps``, clip the weights (reference
        392-398): ``(samples, log_q, w_clipped, eps)``. The samples, the
        model and the weights carry no graph; ``log_q`` carries one where
        the caller records it. A sharded step draws its ``num_samples``
        and reduces over ``axis``."""
        S = num_samples or self.num_mc_samples
        with torch.no_grad():
            samples = self.approx.sample(var_param.detach(), S, generator)
            log_p = self.model(samples)
        log_q = self.approx.log_density(var_param, samples)
        with torch.no_grad():
            eps, _, w = self._eps_and_weights(eps_guess, samples, log_p, log_q.detach(),
                                              axis)
            w_clipped = self._clip_weights(w, axis)
        return samples, log_q, w_clipped, eps

    @staticmethod
    def _ok(state, w_sum):
        return state["ok"] & torch.isfinite(w_sum) & (w_sum > 0.0)

    def _step_no_resampling(self, var_param, generator, state):
        S = self.num_mc_samples
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            _, log_q, w_clipped, eps = self._refresh(vp, generator, state["eps"])
            loss = -torch.dot(w_clipped, log_q) / S
            (grad,) = torch.autograd.grad(loss, vp)
        # the reference raises on degenerate weights in both modes
        # (objectives.py:326-329); self-normalised, they show as a
        # non-finite weight mass
        ok = self._ok(state, torch.sum(w_clipped))
        return loss.detach(), grad, {"eps": eps, "step": state["step"] + 1, "ok": ok}

    def _step_resampling(self, var_param, generator, state):
        S = self.num_mc_samples
        if int(state["step"]) % self._num_resampling_batches == 0:
            # log q is read only through the weights here: no graph, so no
            # adjoint solve and no activations are kept
            with torch.no_grad():
                samples, _, w_clipped, eps = self._refresh(var_param, generator,
                                                           state["eps"])
                w_sum = torch.sum(w_clipped)
                w_norm = w_clipped / w_sum
        else:
            samples, w_norm, w_sum, eps = (state["samples"], state["w_norm"],
                                           state["w_sum"], state["eps"])
        ok = self._ok(state, w_sum)
        # a degenerate draw is flagged in ok and raised at the boundary;
        # the indices then come from uniform weights, since a multinomial
        # draw on non-finite weights is an error
        usable = torch.isfinite(w_sum) & (w_sum > 0.0)
        idx = self._resampler.choice(generator, torch.where(usable, w_norm, 1.0 / S),
                                     self._resampling_batch_size)
        resampled = samples[idx]
        vp = var_param.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean(-self.approx.log_density(vp, resampled)) * w_sum / S
            (grad,) = torch.autograd.grad(loss, vp)
        new_state = {"eps": eps, "step": state["step"] + 1, "samples": samples,
                     "w_norm": w_norm, "w_sum": w_sum, "ok": ok}
        return loss.detach(), grad, new_state

    # -- objective-state protocol ---------------------------------------------
    def init_obj_state(self, var_param):
        dtype, device = var_param.dtype, var_param.device
        state = {"eps": torch.tensor(self._max_eps, dtype=dtype, device=device),
                 "step": torch.tensor(0),
                 "ok": torch.tensor(True, device=device)}
        if self._use_resampling:
            S = self.num_mc_samples
            state.update(
                samples=torch.zeros((S, self.approx.dim), dtype=dtype, device=device),
                w_norm=torch.zeros((S,), dtype=dtype, device=device),
                w_sum=torch.tensor(1.0, dtype=dtype, device=device))
        return state

    def value_and_grad_with_state(self, var_param, generator, obj_state):
        if self._use_resampling:
            return self._step_resampling(var_param, generator, obj_state)
        return self._step_no_resampling(var_param, generator, obj_state)

    def check_obj_state(self, obj_state):
        if "ok" in obj_state and not bool(obj_state["ok"]):
            # the reference's "All weights zero!" raise (objectives.py:
            # 326-329); self-normalised, degeneracy shows as non-finite
            # log weights instead
            raise ValueError("Non-finite importance weights! "
                             "Suggests overflow in importance density.")

    def resize_obj_state(self, obj_state, var_param):
        """The state after a ``num_mc_samples`` change: ``eps`` and ``ok``
        carry over (escalation neither restarts the annealing nor hides a
        weight blow-up already seen); the sample cache is rebuilt at the
        new count and the refresh clock zeroes, so the next step refreshes
        it before anything reads it."""
        fresh = self.init_obj_state(var_param)
        fresh["eps"] = obj_state["eps"]
        fresh["ok"] = obj_state["ok"]
        return fresh

    def mc_sharded_step_with_state(self, mesh, axis_name="mc"):
        """The per-rank stateful step of MC-sample data parallelism (the
        JAX package's objectives.py:851-897): ``step(var_param, generator,
        state) -> (value, grad, state)``. Only without resampling: the
        resampling draw is a categorical over every rank's weights. The
        weights' scale, the bisection's ESS sums and the clip totals are
        all-reduced, so the step visits the same ``eps`` sequence and loss
        as an unsharded step on the concatenated samples; one more SUM
        carries the value, the weight mass and the gradient."""
        if self._use_resampling:
            raise ValueError(
                "MC-axis sharding supports DIS with use_resampling=False only (the "
                "resampling draw is a global categorical over every shard's weights)")
        axis = _ShardAxis(mesh, axis_name)
        axis.local_count(self.num_mc_samples)

        def step(var_param, generator, state):
            S = self.num_mc_samples
            local_S = axis.local_count(S)
            g = axis.generator(generator)
            vp = var_param.detach().requires_grad_(True)
            with torch.enable_grad():
                _, log_q, w_clipped, eps = self._refresh(vp, g, state["eps"],
                                                         num_samples=local_S, axis=axis)
                loss = -torch.dot(w_clipped, log_q) / S
                (grad,) = torch.autograd.grad(loss, vp)
            packed = axis.sum(torch.cat([loss.detach().reshape(1),
                                         torch.sum(w_clipped).reshape(1), grad]))
            ok = self._ok(state, packed[1])
            return packed[0], packed[2:], {"eps": eps, "step": state["step"] + 1, "ok": ok}

        return step

    def reset_obj_state_rows(self, obj_states, idx):
        """The states of restarts ``idx`` set back to a fresh round's, the
        others left running (the async ``multistart_raabbvi``'s round
        reset; the JAX package's objectives.py:810-849). ``obj_states``
        holds one state dict a restart; returns the new list.

        A reset restart's ``eps`` becomes ``max_eps`` and its ``ok`` True.
        With resampling, the JAX package keeps one refresh clock
        (``step``) for the whole batch and zeroes it, so the next step
        refreshes every restart's sample cache, not only the reset one's:
        the reset restart's first step is a fresh round's (its stale cache
        is overwritten before it is read), the others refresh once early.
        The port keeps a clock a restart and zeroes every one of them, to
        step as the JAX package does. Without resampling the clock is
        inert and stays.
        """
        idx = {int(b) for b in idx}
        out = []
        for b, state in enumerate(obj_states):
            state = dict(state)
            if b in idx:
                state["eps"] = torch.full_like(state["eps"], self._max_eps)
                state["ok"] = torch.ones_like(state["ok"])
            if self._use_resampling:
                state["step"] = torch.zeros_like(state["step"])
            out.append(state)
        return out

    def value_and_grad(self, var_param, generator):
        """Direct calls: the state is mirrored on the object and checked
        every step, like the reference."""
        if self._obj_state is None:
            self._obj_state = self.init_obj_state(var_param)
        value, grad, self._obj_state = self.value_and_grad_with_state(
            var_param, generator, self._obj_state)
        self.check_obj_state(self._obj_state)
        return value, grad
