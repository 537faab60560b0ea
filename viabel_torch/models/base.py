"""Model wrapper (counterpart of ``viabel_tpu/models/base.py:Model``).

A model is any callable ``log_density(x) -> (n,)`` over batched parameter
values ``x`` of shape ``(n, dim)``, written with differentiable torch
operations; gradients come from ``torch.autograd``. The JAX model's
``constrain`` and tempering hooks come with the extras that use them
(ROADMAP.md, Queue 1 item 10).
"""

__all__ = ["Model"]


class Model:
    """Wraps an (unnormalized) log density.

    Parameters
    ----------
    log_density : callable
        Maps ``(n, dim)`` tensors to ``(n,)`` log densities.
    """

    def __init__(self, log_density):
        self._log_density = log_density

    def __call__(self, model_param):
        return self._log_density(model_param)
