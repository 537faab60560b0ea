"""Many independent fixed-rate optimizations of one objective
(counterpart of ``viabel_tpu/parallel/sharded.py:148-263``).

``multistart_optimize`` is the plain multistart: B restarts of the
fixed-learning-rate loop, each with a ring iterate average, stepped in
lockstep as B single-restart steps a step (see
:mod:`viabel_torch.parallel.multistart` for why not ``vmap``). The
MC-sharded objectives and the restart-sharded mesh layouts belong to the
distributed engines, which are not ported yet.
"""

import torch

from ..optimizers import _obj_init_state
from ..utils import not_ported
from .multistart import restart_generators

__all__ = ["multistart_optimize"]


def multistart_optimize(sgo, n_iters, objective, init_params, generator=None,
                        mesh=None, restart_axis="restart", mc_axis=None):
    """Run ``B = init_params.shape[0]`` fixed-learning-rate optimizations.

    Parameters
    ----------
    sgo : StochasticGradientOptimizer
        Supplies the step rule and the learning rate.
    objective : VariationalObjective
        Must be stateless (no estimator state): a stateful objective such
        as DIS needs ``multistart_faso``, which threads per-restart state.
    init_params : tensor (n_restarts, var_param_dim)
    generator : torch.Generator, optional
        Seeds one generator a restart
        (:func:`~viabel_torch.parallel.multistart.restart_generators`).
    mesh, restart_axis, mc_axis
        The sharded layouts; not ported yet.

    Each restart's iterate average covers its last ``(n_iters - 1) *
    iterate_avg_prop`` iterates, as in the plain loop. The step is
    ``sgo.step``, the plain loop's, so ``weight_decay`` applies (a
    departure: the JAX package's scan body omits it).

    Returns a dict with ``opt_param`` (n_restarts, D) iterate averages,
    ``final_param`` and ``value_history`` (n_restarts, n_iters).
    """
    if mesh is not None or mc_axis is not None:
        raise not_ported("multistart_optimize(mesh=..., mc_axis=...)", "13b")
    init_params = torch.as_tensor(init_params).detach()
    B, D = init_params.shape
    if _obj_init_state(objective, init_params[0]):
        raise ValueError(
            f"{type(objective).__name__} carries per-step estimator state; "
            "the plain multistart scan cannot thread it — use "
            "multistart_faso / multistart_raabbvi (or bbvi(num_restarts=..., "
            "adaptive=True))")
    generators = restart_generators(generator, B, init_params.device)
    n_iters = int(n_iters)
    lr = sgo._learning_rate
    iap = sgo._iterate_avg_prop
    window = max(1, int((n_iters - 1) * iap)) if iap is not None else 1
    var_params = list(init_params.clone())
    states = [sgo.init_state(vp) for vp in var_params]
    rings = [init_params.new_zeros((window, D)) for _ in range(B)]
    values = [[] for _ in range(B)]
    for i in range(n_iters):
        for b in range(B):
            var_params[b], states[b], _, value, _, _ = sgo.step(
                objective, var_params[b], states[b], {}, generators[b], lr)
            rings[b][i % window] = var_params[b]
            values[b].append(value)
    count = min(n_iters, window)
    return {"opt_param": torch.stack([ring.sum(dim=0) / count for ring in rings]),
            "final_param": torch.stack(var_params),
            "value_history": torch.stack([torch.stack(v) for v in values])}
