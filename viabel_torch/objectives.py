"""Variational objectives (counterpart of ``viabel_tpu/objectives.py``).

Each objective exposes ``value_and_grad(var_param, generator) -> (value,
grad)``: one Monte Carlo loss evaluation and its gradient by
``torch.autograd``, both from the same draws. The generator replaces the
JAX package's explicit PRNG key.
"""

import torch

from .utils import deferred_names, not_ported

__all__ = ["VariationalObjective", "StochasticVariationalObjective",
           "ExclusiveKL"]

#: objectives of the JAX package not ported yet, by ROADMAP.md item
NOT_PORTED = {"IWELBO": 9, "DISInclusiveKL": 9, "AlphaDivergence": 9}
__getattr__ = deferred_names(__name__, NOT_PORTED)


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
    hessian_approx_method : None
        The Miller et al. (2017) control-variate estimators are not ported
        yet (ROADMAP.md, Queue 1 item 9); any other value raises.
    """

    def __init__(self, approx, model, num_mc_samples, use_path_deriv=False,
                 hessian_approx_method=None):
        if hessian_approx_method is not None:
            raise not_ported("ExclusiveKL(hessian_approx_method=...)", 9)
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
