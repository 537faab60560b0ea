"""Stochastic-gradient step rules (counterpart of ``viabel_tpu/optimizers.py``).

Each rule is a pure ``(grad, state) -> (descent_dir, state)`` function
with an explicit ``init_state``; ``optimize`` runs the fixed-learning-rate
loop eagerly, one step per Python iteration. The iterate average is kept
in a ``(window, D)`` ring tensor. An objective's estimator state (the
objective-state protocol of :mod:`viabel_torch.objectives`) is threaded
through the loop; the protocol is duck-typed, so an objective that only
defines ``value_and_grad`` and ``update`` works unchanged.

:class:`_GraphedStep` replays one step of a rule over an objective from
CUDA graphs where :func:`graph_refusal` finds nothing against it; FASO's
segments drive it, and the loop of ``optimize`` here stays eager.
"""

import torch

from .ops import _build
from .tracing import span
from .utils import GraphSafety

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


class StochasticGradientOptimizer(Optimizer, GraphSafety):
    """Fixed-learning-rate SGD with iterate averaging."""

    #: a rule is safe to replay (:class:`GraphSafety`) where, after its
    #: first step, it reads no host value that changes from step to step (a
    #: host entry of its state, such as a step count, may change by the
    #: same amount every step)
    graph_safe = True

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

    #: ``t`` tells only the first step, the seeding one
    graph_safe = True

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


def graph_refusal(sgo, objective, var_param, obj_state, mesh=None):
    """Why the steps of ``sgo`` over ``objective`` cannot be replayed from a
    CUDA graph (:class:`_GraphedStep`), or None where a replayed step is the
    same computation as an eager one. The step rule and the objective, with
    its family and model, state their own safety
    (:class:`~viabel_torch.utils.GraphSafety`); an objective that states
    nothing is refused. To those this adds what the run shows."""
    if sgo._diagnostics:
        return "diagnostics mode keeps every step's gradient and direction"
    if mesh is not None:
        return "the history ring is split over a mesh"
    if obj_state:
        return "the objective threads estimator state between steps"
    for part in (sgo, objective):
        if not isinstance(part, GraphSafety):
            return f"{type(part).__name__} states nothing about replay"
        refusal = part.graph_refusal()
        if refusal is not None:
            return refusal
    if not var_param.is_cuda:
        return "the parameters are not on a CUDA device"
    return None


#: eager steps at a sample count before its step is captured: the first may
#: take a rule's seeding branch, the second is the step the graph records
_WARM_STEPS = 2


class _GraphedStep:
    """One optimizer step of ``sgo`` over ``objective``, replayed from CUDA
    graphs: the loss (draws, model, kernels), ``torch.autograd.grad``, the
    step rule and the update, as one ``CUDAGraph.replay()``.

    A graph holds the step at one sample count S and reads and writes
    static buffers: the iterate, the rule's state tensors and a 0-d
    learning rate, filled where a carry enters. Each replay's loss is
    cloned from the graph's output before the next replay can overwrite
    it; the rule's host entries (RMSProp's ``t``) advance by what the
    recorded step added. The graphs are made from real steps: at each S
    the first ``_WARM_STEPS`` steps run eagerly, and the last of them is
    captured after it ran. Capture runs nothing, so no step is added or
    lost. The step's generator is registered with each graph: a replay
    draws what an eager step would, and leaves the generator where an
    eager step would. A carry at the rule's first step (the host entries
    of ``init_state``) runs eagerly. A capture that raises (a model that
    reads a value back to the host) leaves every later step eager. The
    graphs share one memory pool; of what lives in it, only a graph's own
    loss outlives its replay, and it is read before any other replay, so
    the graphs replay in any order. Kernel launches recorded at capture
    are counted at each replay (``ops.launch_counts()``).

    Every other host value the step reads is frozen at capture: a Python
    float on the model, the family or the objective keeps its value at
    capture in every replay. :func:`graph_refusal` lets through only parts
    that state they read none that changes (``GraphSafety``), and
    :meth:`serves` keys the graphs by the objects in use.
    """

    def __init__(self, sgo, objective, var_param, generator):
        self.sgo, self.objective, self.generator = sgo, objective, generator
        self.model = getattr(objective, "model", None)
        self.var_param = torch.empty_like(var_param)
        self.lr = var_param.new_zeros(())
        self.lr_host = None
        self.first = {k: v for k, v in sgo.init_state(var_param).items()
                      if not isinstance(v, torch.Tensor)}
        self.state = None       # the rule's state tensors, made at the first capture
        self.host_step = {}     # what a step adds to each host entry of the state
        self.graphs = {}        # sample count -> replay
        self.warm = {}          # sample count -> eager steps run at it
        self.failed = False
        self.replays = 0
        self.pool = self.stream = None  # made at the first capture

    def serves(self, sgo, objective, var_param, generator):
        """Whether this helper's graphs are those steps' graphs."""
        like = self.var_param
        return (sgo is self.sgo and objective is self.objective
                and getattr(objective, "model", None) is self.model
                and generator is self.generator and var_param.shape == like.shape
                and var_param.dtype == like.dtype and var_param.device == like.device)

    def step(self, var_param, state, lr):
        """One step from ``(var_param, state)`` at learning rate ``lr``:
        ``(var_param, state, value)``. The iterate and state tensors of a
        replayed step are the static buffers (:meth:`release`)."""
        S = getattr(self.objective, "num_mc_samples", None)
        replay = self.graphs.get(S)
        loaded = var_param is self.var_param
        if replay is None or (not loaded and self.first and all(
                state.get(k) == v for k, v in self.first.items())):
            var_param, out, _, value, _, _ = self.sgo.step(
                self.objective, var_param, state, {}, self.generator, lr)
            self.warm[S] = self.warm.get(S, 0) + 1
            if replay is None and self.warm[S] >= _WARM_STEPS and not self.failed:
                with span("viabel.step.capture"):
                    self._capture(S, state, out)
            return var_param, out, value
        with span("viabel.step.replay"):
            if not loaded:
                self.var_param.copy_(var_param)
                for k, v in self.state.items():
                    v.copy_(state[k])
            if lr != self.lr_host:
                self.lr.fill_(lr)
                self.lr_host = lr
            value = replay().clone()
            self.replays += 1
            state = {**state, **self.state,
                     **{k: state[k] + d for k, d in self.host_step.items()}}
            return self.var_param, state, value

    def release(self, var_param, state):
        """The carry as a caller may keep it: copies of the static buffers,
        which a later replay overwrites."""
        if var_param is not self.var_param:
            return var_param, state
        return var_param.clone(), {k: v.clone() if isinstance(v, torch.Tensor) else v
                                   for k, v in state.items()}

    def _capture(self, S, before, state):
        """Record the step at sample count ``S`` from a carry like
        ``state``, which an eager step just made from ``before``; on
        failure, leave every later step eager."""
        if self.state is None:
            self.state = {k: torch.empty_like(v) for k, v in state.items()
                          if isinstance(v, torch.Tensor)}
        host = {k: v for k, v in state.items() if k not in self.state}

        def body():
            vp, st, _, value, _, _ = self.sgo.step(
                self.objective, self.var_param, {**host, **self.state}, {},
                self.generator, self.lr)
            self.var_param.copy_(vp)
            for k, v in self.state.items():
                v.copy_(st[k])
            return value

        replay = self._record(body)
        if replay is None:
            self.failed = True
            return
        self.host_step = {k: v - before[k] for k, v in host.items()}
        self.graphs[S] = replay

    def _record(self, body):
        """``body``'s device work as a replay callable that returns what
        ``body`` returned, or None where the capture raised. A capture
        launches nothing, so the kernel launches its wrappers counted are
        taken back and counted at each replay."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.var_param.device)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    out = body()
                finally:
                    graph.capture_end()
        except RuntimeError:
            self._end_capture_mode()
            return None
        finally:
            launches = {k: n - before[k] for k, n in _build.launch_counts().items()
                        if n != before[k]}
            for k, n in launches.items():
                _build.count_launch(k, -n)
        current.wait_stream(self.stream)

        def replay():
            graph.replay()
            for k, n in launches.items():
                _build.count_launch(k, n)
            return out

        return replay

    def _end_capture_mode(self):
        """A capture cut short by an error leaves the generators it
        registered (this step's, and the default one) in capture mode, where
        an eager draw raises; one whole capture takes them out of it. Its
        graph is never replayed."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream):
            graph.capture_begin()
            self.lr.add_(0)
            graph.capture_end()
