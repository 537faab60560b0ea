"""MC-sample-axis data parallelism and the plain multistart
(counterpart of ``viabel_tpu/parallel/sharded.py``).

:class:`ShardedExclusiveKL` and :func:`shard_mc_objective` run an
objective's per-rank step (``mc_sharded_step``, or DIS's
``mc_sharded_step_with_state``) over one axis of a ``DeviceMesh``
(:func:`viabel_torch.parallel.make_mesh`): every rank of the axis runs the
same optimizer loop on the same parameters, draws its ``S / n`` samples
and takes part in the step's all-reduces, so every rank holds the same
gradient and the same iterates. Two things the JAX package (one
controller) never meets are handled here:

- ``num_mc_samples`` is settable, and a rung of FASO's ``mc_escalation``
  is rounded up to a multiple of the axis size (the JAX package's
  property is read-only, so its escalation fails on a sharded objective);
- every rank runs its own copy of the host loop, so a decision that reads
  a wall clock (FASO's MCSE recheck schedule and ``max_time``, RAABBVI's
  budget; the escalation's timing rides on the recheck schedule) is taken
  from rank 0 through :meth:`_MCShardedObjective.agree`, one broadcast of
  a float64 scalar a decision, when the axis spans more than one rank.

``multistart_optimize`` is the plain multistart: B restarts of the
fixed-learning-rate loop, each with a ring iterate average, stepped in
lockstep as B single-restart steps a step (see
:mod:`viabel_torch.parallel.multistart` for why not ``vmap``). With a
mesh, the restarts split over its restart axis and each restart's MC
samples optionally over a second axis.
"""

import math

import torch

from ..objectives import ExclusiveKL
from ..optimizers import _obj_check_state, _obj_init_state
from .mesh import MeshAxis, restart_axis_of
from .multistart import restart_generators

__all__ = ["ShardedExclusiveKL", "shard_mc_objective", "multistart_optimize"]


def _round_up(value, n):
    """``value`` rounded up to a multiple of ``n``."""
    return int(math.ceil(int(value) / n)) * n


class ShardedExclusiveKL(ExclusiveKL):
    """``ExclusiveKL`` with the Monte Carlo sample axis sharded over
    ``mesh``'s axis ``axis_name``: each rank draws ``num_mc_samples / n``
    samples and one all-reduce averages the value and the gradient
    (:meth:`ExclusiveKL.mc_sharded_step`). The parameters are replicated.
    For the other objectives use :func:`shard_mc_objective`.

    ``num_mc_samples`` must divide at construction; setting it later
    rounds it up to a multiple of the axis size.
    """

    #: each step all-reduces over the mesh's ranks
    graph_safe = False

    def __init__(self, approx, model, num_mc_samples, mesh, axis_name="mc",
                 use_path_deriv=False):
        self._axis = MeshAxis(mesh, axis_name)
        self._axis.local_count(int(num_mc_samples))
        super().__init__(approx, model, num_mc_samples, use_path_deriv=use_path_deriv)
        self._mesh, self._axis_name = mesh, axis_name
        self._step = self.mc_sharded_step(mesh, axis_name)

    @property
    def num_mc_samples(self):
        return self._num_mc_samples

    @num_mc_samples.setter
    def num_mc_samples(self, value):
        self._num_mc_samples = _round_up(value, self._axis.n)

    def value_and_grad(self, var_param, generator):
        return self._step(var_param, generator)

    def agree(self, x):
        """Rank 0's reading of a host decision (see the module docstring)."""
        return self._axis.agree(x)


class _MCShardedObjective:
    """An objective whose MC sample axis is sharded over a mesh axis
    (built by :func:`shard_mc_objective`). It delegates the
    objective-state protocol, ``update``, ``approx`` and ``model`` to the
    wrapped objective and runs the objective's own per-rank step."""

    scannable = True

    def __init__(self, objective, mesh, axis_name):
        self._inner = objective
        self._axis = MeshAxis(mesh, axis_name)
        build_stateful = getattr(objective, "mc_sharded_step_with_state", None)
        if build_stateful is not None:
            self._step = build_stateful(mesh, axis_name)
            self._stateful = True
        else:
            build = getattr(objective, "mc_sharded_step", None)
            if build is None:
                raise ValueError(f"{type(objective).__name__} does not support MC-axis "
                                 "sharding (no mc_sharded_step)")
            inner_step = build(mesh, axis_name)

            def step(var_param, generator, obj_state):
                value, grad = inner_step(var_param, generator)
                return value, grad, obj_state

            self._step = step
            self._stateful = False
        if hasattr(objective, "reset_obj_state_rows"):
            # the async multistart_raabbvi's round reset
            self.reset_obj_state_rows = objective.reset_obj_state_rows
        self._obj_state = None  # mirror for direct calls

    # -- objective-state protocol ---------------------------------------------
    def init_obj_state(self, var_param):
        return _obj_init_state(self._inner, var_param)

    def value_and_grad_with_state(self, var_param, generator, obj_state):
        return self._step(var_param, generator, obj_state)

    def check_obj_state(self, obj_state):
        _obj_check_state(self._inner, obj_state)

    def resize_obj_state(self, obj_state, var_param):
        resize = getattr(self._inner, "resize_obj_state", None)
        return (resize(obj_state, var_param) if resize is not None
                else self.init_obj_state(var_param))

    def value_and_grad(self, var_param, generator):
        """Direct calls: the state is mirrored on the wrapper and checked
        every step, as the wrapped DIS does (the JAX package's
        ``_mirrored_value_and_grad``)."""
        if self._obj_state is None:
            self._obj_state = self.init_obj_state(var_param)
        value, grad, self._obj_state = self._step(var_param, generator, self._obj_state)
        if self._stateful:
            self.check_obj_state(self._obj_state)
        return value, grad

    def __call__(self, var_param, generator):
        return self.value_and_grad(var_param, generator)

    def update(self, var_param, direction):
        return self._inner.update(var_param, direction)

    def agree(self, x):
        """Rank 0's reading of a host decision (see the module docstring)."""
        return self._axis.agree(x)

    @property
    def approx(self):
        return self._inner.approx

    @property
    def model(self):
        return self._inner.model

    @model.setter
    def model(self, value):
        self._inner.model = value

    @property
    def num_mc_samples(self):
        return self._inner.num_mc_samples

    @num_mc_samples.setter
    def num_mc_samples(self, value):
        # a rung rounded up to a multiple of the axis size: the per-rank
        # count stays whole and the recorded S is the S used
        self._inner.num_mc_samples = _round_up(value, self._axis.n)
        self._obj_state = None


def shard_mc_objective(objective, mesh, axis_name="mc"):
    """Shard a supporting objective's Monte Carlo sample axis over
    ``mesh``'s axis ``axis_name``.

    The objective's own per-rank recipe runs on every rank of the axis:
    ``mc_sharded_step`` (ExclusiveKL with the entropy form or STL, IWELBO,
    AlphaDivergence) or ``mc_sharded_step_with_state`` (DIS with
    ``use_resampling=False``). The parameters are replicated, and the
    all-reduces combine the value and the gradient. The returned object
    takes the objective's place in every optimizer (``SGO.optimize``,
    ``FASO``, ``RAABBVI``, ``bbvi(objective=...)``).
    ``num_mc_samples`` must be divisible by the axis size. An objective
    without a recipe raises ``ValueError``.
    """
    return _MCShardedObjective(objective, mesh, axis_name)


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
    mesh : DeviceMesh, optional
        Restarts split over its axis ``restart_axis``: rank ``r`` of that
        axis runs rows ``[r B/P, (r+1) B/P)`` with their own generators (a
        row does not depend on ``P``), and the results are all-gathered
        in restart order. ``mc_axis`` names a second axis over which each
        restart's MC samples are sharded
        (:func:`shard_mc_objective`), the restart x mc layout. ``B`` must
        be divisible by the restart axis size.

    Each restart's iterate average covers its last ``(n_iters - 1) *
    iterate_avg_prop`` iterates, as in the plain loop. The step is
    ``sgo.step``, the plain loop's, so ``weight_decay`` applies (a
    departure: the JAX package's scan body omits it).

    Returns a dict with ``opt_param`` (n_restarts, D) iterate averages,
    ``final_param`` and ``value_history`` (n_restarts, n_iters).
    """
    init_params = torch.as_tensor(init_params).detach()
    B, D = init_params.shape
    if _obj_init_state(objective, init_params[0]):
        raise ValueError(
            f"{type(objective).__name__} carries per-step estimator state; "
            "the plain multistart scan cannot thread it — use "
            "multistart_faso / multistart_raabbvi (or bbvi(num_restarts=..., "
            "adaptive=True))")
    rows = range(B)
    if mesh is not None:
        restarts = restart_axis_of(mesh, restart_axis, B)
        rows = restarts.rows(B)
        if mc_axis is not None:
            if getattr(objective, "mc_sharded_step", None) is None:
                raise ValueError(f"{type(objective).__name__} does not support MC-axis "
                                 "sharding (no mc_sharded_step)")
            objective = shard_mc_objective(objective, mesh, mc_axis)
    generators = restart_generators(generator, B, init_params.device)[rows.start:rows.stop]
    n_iters = int(n_iters)
    lr = sgo._learning_rate
    iap = sgo._iterate_avg_prop
    window = max(1, int((n_iters - 1) * iap)) if iap is not None else 1
    n_local = len(rows)
    var_params = list(init_params[rows.start:rows.stop].clone())
    states = [sgo.init_state(vp) for vp in var_params]
    rings = [init_params.new_zeros((window, D)) for _ in range(n_local)]
    values = [[] for _ in range(n_local)]
    for i in range(n_iters):
        for b in range(n_local):
            var_params[b], states[b], _, value, _, _ = sgo.step(
                objective, var_params[b], states[b], {}, generators[b], lr)
            rings[b][i % window] = var_params[b]
            values[b].append(value)
    count = min(n_iters, window)
    out = {"opt_param": torch.stack([ring.sum(dim=0) / count for ring in rings]),
           "final_param": torch.stack(var_params),
           "value_history": torch.stack([torch.stack(v) for v in values])}
    if mesh is not None:
        out = {name: restarts.gather(x) for name, x in out.items()}
    return out
