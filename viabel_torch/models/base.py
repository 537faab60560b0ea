"""Model wrappers (counterpart of ``viabel_tpu/models/base.py``).

A model is any callable ``log_density(x) -> (n,)`` over batched parameter
values ``x`` of shape ``(n, dim)``, written with differentiable torch
operations; gradients come from ``torch.autograd``.

A model that draws its own randomness each step (the minibatch of
:class:`SubsampledModel`) sets ``needs_generator = True`` and exposes
``bind(generator)``, which draws that randomness once from the step's
generator and returns the step's model, a plain ``(n, dim) -> (n,)``
callable. The objectives bind once a step, so every evaluation inside one
step sees the same draw (:func:`viabel_torch.objectives._step_model`).
"""

import torch
from torch import func

from ..utils import GraphSafety

__all__ = ["Model", "TemperedModel", "SubsampledModel"]


class Model(GraphSafety):
    """Wraps an (unnormalized) log density.

    Parameters
    ----------
    log_density : callable
        Maps ``(n, dim)`` tensors to ``(n,)`` log densities. Use
        :meth:`from_single` for a per-sample function.
    constrain_fn : callable, optional
        Map from unconstrained parameters to a dict of constrained ones
        (the reference's ``StanModel.constrain``).
    """

    #: models that draw their own per-step randomness set True and define
    #: ``bind(generator)``; this is the JAX package's ``needs_key``, with
    #: the step's generator in place of half of the step's key
    needs_generator = False

    #: a CUDA graph may replay the wrapped callable's device work
    #: (:class:`~viabel_torch.utils.GraphSafety`); host values it reads are
    #: frozen at capture, and a read back to the host makes the capture
    #: fail and the steps run eagerly
    graph_safe = True

    def __init__(self, log_density, constrain_fn=None):
        self._log_density = log_density
        self._constrain_fn = constrain_fn

    @classmethod
    def from_single(cls, log_density_single, **kwargs):
        """Build a model from a per-sample ``(dim,) -> scalar`` log density,
        batched with ``torch.func.vmap``."""
        return cls(func.vmap(log_density_single), **kwargs)

    def __call__(self, model_param):
        return self._log_density(model_param)

    def constrain(self, model_param):
        if self._constrain_fn is None:
            raise NotImplementedError()
        return self._constrain_fn(model_param)

    @property
    def supports_tempering(self):
        return False

    def set_inverse_temperature(self, inverse_temp):
        raise NotImplementedError()


class TemperedModel(Model):
    """A model whose log density is scaled by an inverse temperature:
    ``beta * log_density(x)``."""

    #: ``set_inverse_temperature`` changes a host value between steps
    graph_safe = False

    def __init__(self, log_density, inverse_temp=1.0, **kwargs):
        super().__init__(log_density, **kwargs)
        self._inverse_temp = float(inverse_temp)

    def __call__(self, model_param):
        return self._inverse_temp * self._log_density(model_param)

    @property
    def supports_tempering(self):
        return True

    def set_inverse_temperature(self, inverse_temp):
        self._inverse_temp = float(inverse_temp)


def _leaves(data):
    if isinstance(data, dict):
        return list(data.values())
    if isinstance(data, (tuple, list)):
        return list(data)
    return [data]


def _map_data(fn, data):
    if isinstance(data, dict):
        return {k: fn(v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(fn(v) for v in data)
    return fn(data)


def _uniform_indices(generator, n_data, batch_size, device):
    """The default minibatch draw: ``batch_size`` indices in ``[0, n_data)``,
    uniform with replacement, from ``generator``."""
    return torch.randint(0, n_data, (batch_size,), generator=generator, device=device)


class SubsampledModel(Model):
    """Minibatch data-subsampling model for stochastic VI at dataset scale.

    The log density is estimated once a step as

        ``log_prior(x) + (n_data / batch_size) * log_lik(x, data[idx])``

    with a fresh minibatch ``idx`` drawn uniformly with replacement from
    the step's generator. The estimate is unbiased for the full-data log
    density, hence for the ELBO's model term: use it with ``ExclusiveKL``
    (plain, STL, or control-variate estimators). ``IWELBO``,
    ``AlphaDivergence`` and ``DISInclusiveKL`` exponentiate the model inside
    importance weights and refuse a subsampled model.

    Parameters
    ----------
    log_prior : callable
        ``(S, dim) -> (S,)`` log prior over the model parameters.
    log_likelihood : callable
        ``((S, dim), data_batch) -> (S,)`` log likelihood summed over the
        rows of ``data_batch``, which has the structure of ``data``.
    data : tensor, or tuple or dict of tensors
        The full dataset; every tensor's leading axis is the data axis.
    batch_size : int
        Rows drawn a step, with replacement.
    index_sampler : callable, optional
        ``(generator, n_data, batch_size, device) -> (batch_size,)`` long
        indices; the default is :func:`_uniform_indices`. The JAX package
        draws with ``jax.random.randint``, whose stream torch cannot
        reproduce, so a test injects indices here.
    """

    needs_generator = True
    #: the minibatch is drawn through the ``index_sampler`` hook every step
    graph_safe = False

    def __init__(self, log_prior, log_likelihood, data, batch_size, *,
                 constrain_fn=None, index_sampler=None):
        leaves = _leaves(data)
        if not leaves:
            raise ValueError("data must contain at least one array leaf")
        n_data = int(leaves[0].shape[0])
        if any(int(leaf.shape[0]) != n_data for leaf in leaves):
            raise ValueError("every data leaf must share the leading "
                             "(data) axis length")
        batch_size = int(batch_size)
        if not 0 < batch_size <= n_data:
            raise ValueError("batch_size must be in [1, n_data]")
        super().__init__(None, constrain_fn=constrain_fn)
        self._log_prior = log_prior
        self._log_likelihood = log_likelihood
        self._data = data
        self._device = leaves[0].device
        self._n_data = n_data
        self._batch_size = batch_size
        self._scale = n_data / batch_size
        self._index_sampler = index_sampler or _uniform_indices

    @property
    def n_data(self):
        return self._n_data

    @property
    def batch_size(self):
        return self._batch_size

    def draw_indices(self, generator):
        """One step's minibatch indices."""
        return self._index_sampler(generator, self._n_data, self._batch_size,
                                   self._device)

    def bind(self, generator):
        """Draw the step's minibatch and return the step's model."""
        idx = self.draw_indices(generator)
        batch = _map_data(lambda leaf: leaf[idx], self._data)
        scale = self._scale

        def step_model(model_param):
            return (self._log_prior(model_param)
                    + scale * self._log_likelihood(model_param, batch))

        return step_model

    def __call__(self, model_param, generator):
        return self.bind(generator)(model_param)

    def full_data_log_density(self, model_param):
        """The exact full-data log density (validation, diagnostics)."""
        return (self._log_prior(model_param)
                + self._log_likelihood(model_param, self._data))
