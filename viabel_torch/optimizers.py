"""Stochastic-gradient step rules (counterpart of ``viabel_tpu/optimizers.py``).

Each rule is a pure ``(grad, state) -> (descent_dir, state)`` function
with an explicit ``init_state``; ``optimize`` runs the fixed-learning-rate
loop eagerly, one step per Python iteration. The iterate average is kept
in a ``(window, D)`` ring tensor. An objective's estimator state (the
objective-state protocol of :mod:`viabel_torch.objectives`) is threaded
through the loop; the protocol is duck-typed, so an objective that only
defines ``value_and_grad`` and ``update`` works unchanged.
"""

import torch

from .tracing import span

__all__ = ["Optimizer", "StochasticGradientOptimizer", "RMSProp",
           "AveragedRMSProp", "Adam", "AveragedAdam", "Adagrad", "WindowedAdagrad"]


def default_generator(device):
    """The generator used when a caller passes none (seed 0, like the JAX
    package's ``PRNGKey(0)`` default)."""
    return torch.Generator(device).manual_seed(0)


def _obj_init_state(objective, var_param):
    fn = getattr(objective, "init_obj_state", None)
    return fn(var_param) if fn is not None else {}


def _obj_step(objective, var_param, generator, obj_state):
    fn = getattr(objective, "value_and_grad_with_state", None)
    if fn is not None:
        return fn(var_param, generator, obj_state)
    value, grad = objective.value_and_grad(var_param, generator)
    return value, grad, obj_state


def _obj_check_state(objective, obj_state):
    fn = getattr(objective, "check_obj_state", None)
    if fn is not None:
        fn(obj_state)


class Optimizer:
    """Abstract optimizer."""

    def optimize(self, n_iters, objective, init_param, generator=None):
        """Run optimization; returns a dict containing at least ``opt_param``."""
        raise NotImplementedError()


class StochasticGradientOptimizer(Optimizer):
    """Fixed-learning-rate SGD with iterate averaging."""

    def __init__(self, learning_rate, *, weight_decay=0.0, iterate_avg_prop=0.2,
                 diagnostics=False):
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay)
        if iterate_avg_prop is not None and (iterate_avg_prop > 1.0
                                             or iterate_avg_prop <= 0.0):
            raise ValueError('"iterate_avg_prop" must be None or between 0 and 1')
        self._iterate_avg_prop = iterate_avg_prop
        self._diagnostics = diagnostics

    def init_state(self, var_param):
        """Initial optimizer state."""
        return {}

    def descent_direction(self, grad, state):
        """Pure step rule: ``(grad, state) -> (descent_dir, new_state)``."""
        return grad, state

    def reset_state(self):
        """Kept for API parity with the JAX package; the state is explicit,
        so there is nothing to reset."""

    def step(self, objective, var_param, state, obj_state, generator, learning_rate):
        """One step: ``(var_param, state, obj_state, value, direction,
        grad)``."""
        value, grad, obj_state = _obj_step(objective, var_param, generator, obj_state)
        with span("viabel.step.rule"):
            direction, state = self.descent_direction(grad, state)
            var_param = objective.update(var_param, learning_rate * direction)
            if self._weight_decay > 0.0:
                var_param = var_param * (1.0 - self._weight_decay)
        return var_param, state, obj_state, value, direction, grad

    #: steps per progress report when a ``progress_callback`` is given
    progress_every = 200

    def optimize(self, n_iters, objective, init_param, generator=None,
                 progress_callback=None):
        """Run the fixed-learning-rate loop.

        ``progress_callback(k, avg_loss)`` is invoked every
        ``progress_every`` steps (and at the end) with the mean loss of
        the steps since the last report. The objective's state is checked
        at the end of the run, and a non-empty one is returned as
        ``results["obj_state"]``.
        """
        var_param = init_param.detach().clone()
        if generator is None:
            generator = default_generator(var_param.device)
        iap = self._iterate_avg_prop
        diagnostics = self._diagnostics
        # reference window: int(k * iap) with k the final iteration index
        window = max(1, int((n_iters - 1) * iap)) if iap is not None else 1
        ring = torch.zeros((window, var_param.shape[0]), dtype=var_param.dtype,
                           device=var_param.device)
        state = self.init_state(var_param)
        obj_state = _obj_init_state(objective, var_param)
        values, params, dirs = [], [], []
        for i in range(n_iters):
            var_param, state, obj_state, value, direction, _ = self.step(
                objective, var_param, state, obj_state, generator, self._learning_rate)
            ring[i % window] = var_param
            values.append(value)
            if diagnostics:
                params.append(var_param)
                dirs.append(direction)
            if progress_callback is not None and (
                    (i + 1) % self.progress_every == 0 or i + 1 == n_iters):
                seg_len = (i + 1) % self.progress_every or self.progress_every
                progress_callback(i + 1, float(torch.stack(values[-seg_len:]).mean()))
        _obj_check_state(objective, obj_state)
        results = {"value_history": torch.stack(values)}
        if diagnostics:
            results["variational_param_history"] = torch.stack(params)
            results["descent_dir_history"] = torch.stack(dirs)
        if iap is not None:
            results["opt_param"] = ring.sum(dim=0) / min(n_iters, window)
        else:
            results["opt_param"] = var_param
        if obj_state:
            results["obj_state"] = obj_state
        return results


class RMSProp(StochasticGradientOptimizer):
    """RMSProp; like the reference, the state is seeded with the first
    squared gradient (reference optimization.py:189-196)."""

    def __init__(self, learning_rate, *, weight_decay=0.0, iterate_avg_prop=0.2,
                 beta=0.9, jitter=1e-8, diagnostics=False):
        self._beta = float(beta)
        self._jitter = float(jitter)
        super().__init__(learning_rate, weight_decay=weight_decay,
                         iterate_avg_prop=iterate_avg_prop, diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"avg_grad_sq": torch.zeros_like(var_param), "t": 0}

    def descent_direction(self, grad, state):
        if state["t"] == 0:
            nu = grad**2
        else:
            nu = self._beta * state["avg_grad_sq"] + (1.0 - self._beta) * grad**2
        direction = grad / torch.sqrt(self._jitter + nu)
        return direction, {"avg_grad_sq": nu, "t": state["t"] + 1}


class AveragedRMSProp(StochasticGradientOptimizer):
    """Averaged RMSProp (Mukkamala & Hein 2017): ``beta_k = 1 - 1/k``."""

    def __init__(self, learning_rate, *, jitter=1e-8, diagnostics=False,
                 component_wise=True):
        self._jitter = float(jitter)
        self._component_wise = bool(component_wise)
        super().__init__(learning_rate, diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"avg_grad_sq": torch.zeros_like(var_param), "t": 0}

    def descent_direction(self, grad, state):
        t = state["t"] + 1
        beta = 1.0 - 1.0 / t
        nu = beta * state["avg_grad_sq"] + (1.0 - beta) * grad**2
        if self._component_wise:
            direction = grad / torch.sqrt(self._jitter + nu)
        else:
            direction = grad / torch.sqrt(self._jitter + torch.sum(nu))
        return direction, {"avg_grad_sq": nu, "t": t}


class Adam(StochasticGradientOptimizer):
    """Adam (Kingma & Ba 2015); like the reference, the moments are seeded
    with the first gradient and there is no bias correction (reference
    optimization.py:260-326)."""

    def __init__(self, learning_rate, *, beta1=0.9, beta2=0.999, jitter=1e-8,
                 iterate_avg_prop=0.2, diagnostics=False):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._jitter = float(jitter)
        super().__init__(learning_rate, iterate_avg_prop=iterate_avg_prop,
                         diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"momentum": torch.zeros_like(var_param),
                "avg_grad_sq": torch.zeros_like(var_param), "t": 0}

    def descent_direction(self, grad, state):
        m, nu = state["momentum"], state["avg_grad_sq"]
        if state["t"] == 0:
            m, nu = grad, grad**2
        m = self._beta1 * m + (1.0 - self._beta1) * grad
        nu = self._beta2 * nu + (1.0 - self._beta2) * grad**2
        direction = m / torch.sqrt(self._jitter + nu)
        return direction, {"momentum": m, "avg_grad_sq": nu, "t": state["t"] + 1}


class AveragedAdam(StochasticGradientOptimizer):
    """Averaged Adam (reference optimization.py:328-396): Adam's momentum
    (seeded with the first gradient) over AveragedRMSProp's ``beta_k = 1 -
    1/k`` second moment."""

    def __init__(self, learning_rate, *, beta1=0.9, jitter=1e-8,
                 diagnostics=False, component_wise=True):
        self._beta1 = float(beta1)
        self._jitter = float(jitter)
        self._component_wise = bool(component_wise)
        super().__init__(learning_rate, diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"momentum": torch.zeros_like(var_param),
                "avg_grad_sq": torch.zeros_like(var_param), "t": 0}

    def descent_direction(self, grad, state):
        m = grad if state["t"] == 0 else state["momentum"]
        m = self._beta1 * m + (1.0 - self._beta1) * grad
        t = state["t"] + 1
        beta2 = 1.0 - 1.0 / t
        nu = beta2 * state["avg_grad_sq"] + (1.0 - beta2) * grad**2
        if self._component_wise:
            direction = m / torch.sqrt(self._jitter + nu)
        else:
            direction = m / torch.sqrt(self._jitter + torch.sum(nu))
        return direction, {"momentum": m, "avg_grad_sq": nu, "t": t}


class Adagrad(StochasticGradientOptimizer):
    """Adagrad (Duchi et al. 2011; reference optimization.py:398-433)."""

    def __init__(self, learning_rate, *, weight_decay=0.0, jitter=1e-8,
                 iterate_avg_prop=0.2, diagnostics=False):
        self._jitter = float(jitter)
        super().__init__(learning_rate, weight_decay=weight_decay,
                         iterate_avg_prop=iterate_avg_prop, diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"sum_grad_sq": torch.zeros_like(var_param)}

    def descent_direction(self, grad, state):
        s = state["sum_grad_sq"] + grad**2
        return grad / torch.sqrt(self._jitter + s), {"sum_grad_sq": s}


class WindowedAdagrad(StochasticGradientOptimizer):
    """Windowed Adagrad (PyMC3's default; reference optimization.py:435-476):
    the mean of the last ``window_size`` squared gradients, kept in a
    ``(window_size, D)`` ring that each step writes in place (the state
    passed in is consumed)."""

    def __init__(self, learning_rate, *, weight_decay=0.0, window_size=10,
                 jitter=1e-8, diagnostics=False):
        self._window_size = int(window_size)
        self._jitter = float(jitter)
        super().__init__(learning_rate, weight_decay=weight_decay,
                         diagnostics=diagnostics)

    def init_state(self, var_param):
        return {"ring": var_param.new_zeros((self._window_size, var_param.shape[0])),
                "t": 0}

    def descent_direction(self, grad, state):
        ring, t = state["ring"], state["t"]
        ring[t % self._window_size] = grad**2
        mean_sq = torch.sum(ring, dim=0) / min(t + 1, self._window_size)
        return grad / torch.sqrt(self._jitter + mean_sq), {"ring": ring, "t": t + 1}
