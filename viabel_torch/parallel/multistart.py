"""Multistart FASO: B restarts with per-restart convergence detection
(counterpart of ``viabel_tpu/parallel/multistart.py``).

``multistart_faso`` runs B independent FASO optimizations of one objective
in lockstep ``k_check``-step segments, each restart with its own history
ring, optimizer state, objective state and generator. Every convergence
statistic (multi-window split-R-hat, window means, windowed ESS/MCSE) is
computed for every restart at each check, one ring at a time, so the peak
extra memory is one ring's worth. Verdicts are read back pipelined as in
single-run FASO.

PyTorch runs eagerly, and the objectives take gradients with
``torch.autograd.grad`` on a leaf, which ``torch.func.vmap`` cannot
transform (nor can the CUDA kernels, which have no batching rule). So a
batched step is B single-restart steps in turn, restart-major inside each
step, which is launch for launch what the JAX package's vmapped segment
scan computes. Restarts that have stopped keep stepping (their averages
are frozen at their own stop), so their generators and states advance as
in the JAX package.

Draw streams: the JAX package splits the key per restart. Here restart
``b`` draws from its own ``torch.Generator``, seeded from the caller's
generator (:func:`restart_generators`); a single restart (``B = 1``) draws
from the caller's generator itself, so ``multistart_faso`` at ``B = 1``
is the port's ``FASO.optimize`` on the same generator.

With ``mesh=`` the restarts split over the mesh's restart axis: each rank
steps its ``B / P`` restarts and keeps their rings, and the per-restart
statistics (R-hat rows, ESS/MCSE rows, window means) are all-gathered in
restart order, so every rank runs the same host bookkeeping on all B
restarts and takes every decision alike; clock readings are rank 0's.
The results are the unsharded run's on every rank; ``resume_state``
carries this rank's rings (their restarts in ``ring_restarts``) and
everything else whole. A resume state resumes on any mesh shape: the
whole state (an unsharded run's, or the ranks' states joined by
:func:`viabel_torch.faso.merge_resume_states`) gives each rank its
restarts' rings.
"""

from collections import deque

import numpy as np
import torch

from ..detection import (_candidate_windows, _CheckCadence, _detection_geometry,
                         _events_array, _host_handle, _MCLadder, _mcse_check, _read_host,
                         _recheck_scale, _to_host_async)
from ..families import MFGaussian
from ..mc_diagnostics import ring_window_mean, split_rhat_ring_windows
from ..optimizers import (StochasticGradientOptimizer, _obj_check_state, _obj_init_state,
                          default_generator)
from ..utils import Timer, _clone_state, _int_list, _now, _set_generator_state
from .mesh import restart_axis_of

__all__ = ["multistart_faso", "restart_generators"]


def restart_generators(generator, B, device):
    """One ``torch.Generator`` a restart, on ``device``.

    ``B = 1`` gets the caller's generator itself (by default seed 0 on
    ``device``), so a single restart consumes the caller's stream as a
    single run does. For ``B > 1`` each restart's generator is seeded by
    one draw of the caller's: a departure from the JAX package, whose
    ``jax.random.split`` torch's generators cannot reproduce.
    """
    if generator is None:
        generator = default_generator(device)
    if B == 1:
        return [generator]
    seeds = torch.randint(0, 2**62, (B,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device).manual_seed(int(s)) for s in seeds]


def _to_device(obj, device):
    """``obj`` with every tensor in it moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _gather_owned(restarts, items, device=None):
    """A B-long list whose entry ``b`` is the one the rank owning restart
    ``b`` on the ``restarts`` axis holds in ``items`` (a copy of ``items``
    without a split); tensors come back on ``device``, or on the host."""
    if restarts is None:
        return list(items)
    parts = restarts.gather_objects([items[b] for b in restarts.rows(len(items))])
    out = [item for part in parts for item in part]
    return out if device is None else _to_device(out, device)


def _resume_rings(rs, local, B, like):
    """A B-long list holding copies of the resume state's rings of the
    restarts in ``local`` (on ``like``'s device and dtype), ``None``
    elsewhere. The state's rings are all B (``ring_restarts`` ``[0, B,
    B]``, or none) or exactly ``local``'s; a state that holds another
    rank's restarts, or belongs to another B, raises ``ValueError``."""
    saved = list(rs["rings"])
    a, b, B_saved = _int_list(rs.get("ring_restarts", (0, len(saved), len(saved))))
    if B_saved != B or b - a != len(saved):
        raise ValueError(f"resume_state holds the rings of restarts [{a}, {b}) of "
                         f"{B_saved}; this run has {B} restarts")
    if (a, b) != (0, B) and (a, b) != (local.start, local.stop):
        raise ValueError(
            f"resume_state holds the rings of restarts [{a}, {b}) of {B}, one rank's "
            f"share, and this rank runs [{local.start}, {local.stop}): join every rank's "
            "state with merge_resume_states first")
    rings = [None] * B
    for r in local:
        rings[r] = torch.as_tensor(saved[r - a]).to(like, copy=True)
    return rings


def _ring_span(restarts, local, B):
    """A sharded run's ``ring_restarts`` entry: which restarts' rings this
    rank's resume state holds."""
    return {} if restarts is None else {
        "ring_restarts": np.asarray([local.start, local.stop, B])}


class _BatchedEngine:
    """B restarts of one configuration (objective, step rule, B, D, ring
    group G, detection gates): the lockstep segment runner and the
    per-restart ring statistics. It holds no run state, so a round-driving
    caller (``multistart_raabbvi``) can call it round after round.

    ``restarts`` (a :class:`~viabel_torch.parallel.mesh.MeshAxis`) splits
    the restarts over ranks: this rank steps and keeps the rings of
    ``local`` only, and every statistic is gathered to all ranks."""

    def __init__(self, sgo, objective, init_params, *, G, diagnostics,
                 rhat_allowed, rhat_threshold, restarts=None):
        self.B, self.D = init_params.shape
        self.dtype, self.device = init_params.dtype, init_params.device
        self.restarts = restarts
        self.local = range(self.B) if restarts is None else restarts.rows(self.B)
        self.G = G
        self.diagnostics = diagnostics
        self._sgo = sgo
        self._objective = objective
        self._exceed = None if rhat_allowed is None else rhat_threshold
        self.mf_dim = (objective.approx.dim
                       if isinstance(getattr(objective, "approx", None), MFGaussian)
                       else None)
        # the objective-state protocol is duck-typed: a stateless objective
        # has the empty state
        self.stateful = bool(_obj_init_state(objective, init_params[0]))

    def run_segment(self, run, steps):
        """``steps`` lockstep steps of every restart of ``run`` (a
        :class:`_RunState`, updated in place), each iterate written to its
        ring's slot ``t % R``. Returns ``(values (B, steps), grads,
        dirs)``, the last two ``(B, steps, D)`` host arrays in diagnostics
        mode, else ``None``."""
        objective, sgo, local = self._objective, self._sgo, self.local
        R = run.rings[local[0]].shape[0]
        values = [[] for _ in local]
        grads = [[] for _ in local] if self.diagnostics else None
        dirs = [[] for _ in local] if self.diagnostics else None
        for _ in range(steps):
            for i, b in enumerate(local):
                (run.var_params[b], run.opt_states[b], run.obj_states[b], value,
                 direction, grad) = sgo.step(objective, run.var_params[b],
                                             run.opt_states[b], run.obj_states[b],
                                             run.generators[b], float(run.lr[b]))
                run.rings[b][(run.t - run.origins[b]) % R] = run.var_params[b]
                values[i].append(value)
                if self.diagnostics:
                    grads[i].append(grad)
                    dirs[i].append(direction)
            run.t += 1
        out = self.gather_rows(torch.stack([torch.stack(v) for v in values]))
        if not self.diagnostics:
            return out, None, None
        return (out,
                self.gather_rows(torch.stack([torch.stack(g) for g in grads])).cpu().numpy(),
                self.gather_rows(torch.stack([torch.stack(d) for d in dirs])).cpu().numpy())

    # -- the restart split ----------------------------------------------------
    def gather_rows(self, x):
        """``(B, ...)`` from this rank's ``(len(local), ...)`` rows."""
        return x if self.restarts is None else self.restarts.gather(x)

    def gather_list(self, items, device=None):
        """:func:`_gather_owned` over this engine's restart split."""
        return _gather_owned(self.restarts, items, device)

    def agree(self, x):
        """Rank 0's reading of a clock over the restart axis."""
        return x if self.restarts is None else self.restarts.agree(x)

    def _owned(self, keys):
        """``keys`` (restart indices, sorted) that this rank owns, and the
        count each rank owns."""
        keys = sorted(keys)
        if self.restarts is None:
            return keys, None
        per = self.B // self.restarts.n
        sizes = [sum(1 for b in keys if b // per == r) for r in range(self.restarts.n)]
        return [b for b in keys if b in self.local], sizes

    def _gather_keyed(self, rows, keys, sizes):
        """``{b: row}`` for every b in ``keys`` from each owner's rows."""
        if sizes is None:
            return rows
        if not keys:
            return {}
        mine = [rows[b] for b in sorted(rows)]
        x = (torch.stack(mine) if mine
             else torch.zeros((0, self.D), dtype=self.dtype, device=self.device))
        return dict(zip(sorted(keys), self.restarts.gather(x, sizes)))

    def rhat_one(self, ring, t, windows):
        """``(K,)`` split-R-hat statistics of one ring whose clock reads
        ``t`` (or above-threshold counts in quantile mode)."""
        return split_rhat_ring_windows(ring, t, windows, self.G,
                                       exceed_threshold=self._exceed)

    def mean_one(self, ring, t, w):
        """``(D,)`` mean of one ring's last ``w`` iterates."""
        return ring_window_mean(ring, t, int(w), self.G)

    def mcse_one(self, ring, t, w):
        """``(D,)`` windowed ESS and MCSE of one ring (device tensors)."""
        return _mcse_check(ring, t, int(w), self.mf_dim)

    def rhat_rows(self, rings, clocks, windows):
        """``(B, K)`` split-R-hat statistics of the rings in ``clocks``
        (``{b: ring clock}``), one ring at a time; ``inf`` in the other
        rows."""
        local = self.local
        out = torch.full((len(local), len(windows)), torch.inf, dtype=self.dtype,
                         device=self.device)
        for i, b in enumerate(local):
            if b in clocks:
                out[i] = self.rhat_one(rings[b], clocks[b], windows)
        return self.gather_rows(out)

    def rhats(self, rings, t, windows):
        """``(B, K)`` split-R-hat statistics, one ring at a time."""
        return self.rhat_rows(rings, dict.fromkeys(range(self.B), t), windows)

    def mean_rows(self, rings, specs):
        """``{b: (D,) mean}`` of ring ``b``'s last ``w`` iterates at ring
        clock ``t``, for every ``b: (t, w)`` in ``specs``."""
        mine, sizes = self._owned(specs)
        rows = {b: self.mean_one(rings[b], *specs[b]) for b in mine}
        return self._gather_keyed(rows, specs, sizes)

    def mean_of(self, b, rings, t, w):
        """Ring ``b``'s ``(D,)`` mean on every rank."""
        return self.mean_rows(rings, {b: (t, w)})[b]

    def means(self, rings, t, ws):
        """``(B, D)`` means of each ring's last ``ws[b]`` iterates."""
        rows = self.mean_rows(rings, {b: (t, int(w)) for b, w in enumerate(ws)})
        return torch.stack([rows[b] for b in range(self.B)])

    def mcse_rows(self, rings, specs):
        """``{b: (ess, mcse)}`` host arrays of ring ``b``'s windowed ESS
        and MCSE, for every ``b: (t, w)`` in ``specs``."""
        mine, sizes = self._owned(specs)
        pairs = {b: self.mcse_one(rings[b], *specs[b]) for b in mine}
        effs = self._gather_keyed({b: p[0] for b, p in pairs.items()}, specs, sizes)
        mcses = self._gather_keyed({b: p[1] for b, p in pairs.items()}, specs, sizes)
        return {b: (effs[b].cpu().numpy(), mcses[b].cpu().numpy()) for b in sorted(specs)}

    def mcses(self, rings, t, ws):
        """``(B, D)`` host arrays of windowed ESS and MCSE per ring."""
        rows = self.mcse_rows(rings, {b: (t, int(w)) for b, w in enumerate(ws)})
        return (np.stack([rows[b][0] for b in range(self.B)]),
                np.stack([rows[b][1] for b in range(self.B)]))

    def init_obj_states(self, var_params):
        return [_obj_init_state(self._objective, vp) for vp in var_params]

    def resize_obj_states(self, obj_states, var_params):
        """Every restart's state re-derived at the objective's new sample
        count (the shared ``mc_escalation`` rung), through the objective's
        ``resize_obj_state`` hook as single-run FASO's escalation does."""
        resize = getattr(self._objective, "resize_obj_state", None)
        return [st if b not in self.local
                else resize(st, vp) if resize is not None
                else _obj_init_state(self._objective, vp)
                for b, (st, vp) in enumerate(zip(obj_states, var_params))]

    def check_obj_states(self, obj_states, obj_errors, k):
        """The objective's validity hook per restart. A failure is recorded
        in ``obj_errors`` (in place) instead of raised: one degenerate
        restart must not destroy the other B - 1 results."""
        for b in self.local:
            if obj_errors[b] is not None:
                continue
            try:
                _obj_check_state(self._objective, obj_states[b])
            except ValueError as e:
                obj_errors[b] = str(e)
                print(f"WARNING: restart {b} objective state invalid at iteration "
                      f"{k} ({e}); its results are unreliable")


class _RunState:
    """The per-restart tensors a segment advances: parameters, step-rule
    and objective states, generators, rings, learning rates, and the
    shared step counter ``t``. Restart ``b`` writes step ``t`` to its
    ring's slot ``(t - origins[b]) % R``: its ring clock starts at
    ``origins[b]`` (0 here; the async ``multistart_raabbvi`` restarts a
    restart's clock with each of its rounds)."""

    def __init__(self, var_params, opt_states, obj_states, generators, rings, lr, t,
                 origins=None):
        self.var_params, self.opt_states, self.obj_states = var_params, opt_states, obj_states
        self.generators, self.rings, self.lr, self.t = generators, rings, lr, t
        self.origins = [0] * len(var_params) if origins is None else origins


def multistart_faso(sgo, n_iters, objective, init_params, generator=None, *,
                    learning_rate=None, mcse_threshold=None, W_min=200, ESS_min=None,
                    k_check=None, max_history=None, rhat_threshold=1.1,
                    rhat_quantile=None, rhat_backoff=None, rhat_group=None,
                    check_pipeline=4, diagnostics=None, resume_state=None, mesh=None,
                    restart_axis="restart", generators=None, init_opt_states=None,
                    max_time=None, mc_escalation=None, mc_max_samples=None,
                    mc_patience=3, mc_plateau_rtol=0.05):
    """Run ``B = init_params.shape[0]`` FASO optimizations in lockstep.

    Semantics per restart match ``FASO.optimize`` (R-hat window search
    every ``k_check`` steps, back-dated convergence, MCSE/ESS stopping
    with cost-aware rechecks); a restart that stops has its iterate
    average frozen at its own ``k_stopped`` while the rest keep
    optimizing, and the run ends early once every restart has stopped.

    ``learning_rate`` / ``mcse_threshold``: a scalar, or shape ``(B,)`` for
    per-restart values (an lr grid, or RAABBVI rounds at each restart's
    decayed rate). A scalar ``learning_rate`` overrides ``sgo``'s rate.
    Defaults: ``sgo``'s rate and 0.1, except on resume, where the
    checkpointed per-restart values are restored unless passed again.

    ``diagnostics``: ``None`` inherits ``sgo``'s flag, like FASO; then the
    per-step gradient and direction histories stream to the host, every
    R-hat verdict is read at once, and the per-check iterate-average and
    ESS/MCSE trails are recorded (each entry carries every restart; the
    ``ess_due_history`` mask flags the rows that were due).

    ``rhat_quantile`` / ``rhat_backoff`` carry FASO's large-d options over:
    quantile gates per restart, and one shared check cadence that doubles
    only while every unconverged restart is far from the gate.

    ``mc_escalation`` / ``mc_max_samples`` / ``mc_patience`` /
    ``mc_plateau_rtol``: FASO's gradient-SNR escalation, shared across the
    batch (one ``num_mc_samples``): the ladder climbs only when every
    still-running restart's binding gate statistic has plateaued, resizes
    every restart's objective state, and resets the shared cadence and the
    live restarts' MCSE recheck horizons. Events land in
    ``results["mc_escalation_history"]``.

    ``generator`` drives the per-restart generators
    (:func:`restart_generators`); ``generators`` (one a restart) and
    ``init_opt_states`` (one step-rule state a restart) override them, so
    that a caller driving rounds keeps each restart's stream and state.
    ``resume_state``: a prior run's ``results["resume_state"]``; the run
    continues from that segment boundary with the same per-restart
    bookkeeping (in-flight verdicts included) and sets each restart's
    saved generator state (at ``B = 1`` into ``generator``).
    ``max_time`` (seconds): a wall-clock budget checked at segment
    boundaries; on expiry the results carry ``timed_out`` and a resumable
    snapshot.

    ``mesh`` / ``restart_axis``: the restarts split over that axis of a
    ``DeviceMesh`` (``B`` divisible by its size); every rank calls with the
    same arguments and gets the same results (see the module docstring).
    ``generators`` and ``init_opt_states`` stay B long. A resume runs on
    any mesh shape from the whole state (see the module docstring), or on
    the same mesh from this rank's own.

    Returns a dict with ``opt_param`` (B, D), per-restart ``k_conv`` /
    ``k_Rhat`` / ``k_stopped`` lists (None where not reached),
    ``final_param`` (B, D), ``value_history`` (B, n_steps_run),
    ``opt_states_at_stop`` (each stopped restart's step-rule state as of
    its own stop; the others' end-of-run state), ``timed_out`` and
    ``resume_state``; ``obj_state_errors`` for a stateful objective; with
    diagnostics also ``grad_history`` / ``descent_dir_history`` (B, n, D),
    ``iterate_average_k_history`` with ``iterate_average_history``
    (n_checks, B, D), and ``ess_and_mcse_k_history`` / ``ess_due_history``
    / ``ess_history`` / ``mcse_history``.
    """
    if not isinstance(sgo, StochasticGradientOptimizer):
        raise ValueError("sgo must be a subclass of StochasticGradientOptimizer")
    diagnostics = sgo._diagnostics if diagnostics is None else bool(diagnostics)
    init_params = torch.as_tensor(init_params).detach()
    B, D = init_params.shape
    device, dtype = init_params.device, init_params.dtype
    if not getattr(objective, "scannable", True):
        raise ValueError("multistart_faso requires a scannable objective "
                         "(host-loop objectives need single-run FASO)")
    restarts = None if mesh is None else restart_axis_of(mesh, restart_axis, B)
    n_iters = int(n_iters)
    k_check, ESS_min, G, R, rhat_allowed = _detection_geometry(
        D, W_min, k_check, ESS_min, rhat_group, rhat_quantile, rhat_backoff,
        int(max_history) if max_history else max(n_iters, 2))
    gate = rhat_threshold if rhat_allowed is None else rhat_allowed

    lr = np.broadcast_to(np.asarray(sgo._learning_rate if learning_rate is None
                                    else learning_rate, dtype=float), (B,)).copy()
    mcse_thresholds = np.broadcast_to(np.asarray(
        0.1 if mcse_threshold is None else mcse_threshold, dtype=float), (B,)).copy()
    engine = _BatchedEngine(sgo, objective, init_params, G=G, diagnostics=diagnostics,
                            rhat_allowed=rhat_allowed, rhat_threshold=rhat_threshold,
                            restarts=restarts)
    local = engine.local
    stateful = engine.stateful
    # the ceiling and the event log are sized from the entry S
    ladder = _MCLadder(objective, B, mc_escalation, mc_max_samples, mc_patience,
                       mc_plateau_rtol)

    var_params = list(init_params.clone())
    opt_states = ([sgo.init_state(vp) for vp in var_params] if init_opt_states is None
                  else [_clone_state(st) for st in init_opt_states])
    obj_states = engine.init_obj_states(var_params) if resume_state is None else None
    # a resumed run sets each generator's saved state below
    generators = list(restart_generators(generator, B, device) if generators is None
                      else generators)
    if len(generators) != B:
        raise ValueError(f"{len(generators)} generators for {B} restarts")
    # a resumed run brings its own rings; this rank keeps its restarts'
    rings = ([torch.zeros((R, D), dtype=dtype, device=device) if b in local else None
              for b in range(B)]
             if resume_state is None else None)
    t = 0
    k = 0
    k_conv = np.full(B, -1)
    k_Rhat = np.full(B, -1)
    k_stopped = np.full(B, -1)
    W_check = np.full(B, -1)
    last_best_W = np.full(B, -1)
    frozen = [None] * B            # averages frozen at each restart's stop
    # each restart's step-rule state at its own stop (the MCSE stop fires
    # at the current segment boundary, so the live state IS the at-stop one)
    opt_stop_rows = [None] * B
    last_checked_avg = [None] * B  # the average at the last MCSE check
    obj_errors = [None] * B        # first objective-state failure per restart
    values_hist, grad_hist, dir_hist = [], [], []
    avg_snapshot = init_params.clone() if diagnostics else None
    iter_avg_k_hist, iter_avg_hist = [], []
    mcse_k_hist, mcse_due_hist, ess_hist, mcse_hist = [], [], [], []
    # diagnostics reads every verdict at once, matching FASO's schedule
    pipeline = 0 if diagnostics else int(check_pipeline)
    pending = deque()
    mcse_time_total = 0.0
    resumed_opt_time = 0.0

    if resume_state is not None:
        rs = resume_state
        var_params = [torch.as_tensor(v).to(init_params).clone()
                      for v in rs["var_params"]]
        opt_states = [_clone_state(st) for st in rs["opt_states"]]
        obj_states = [_clone_state(st) for st in rs["obj_states"]]
        for g, state in zip(generators, rs["generator_states"]):
            _set_generator_state(g, state)
        # copies: segments write the rings in place, and the caller's
        # snapshot must stay valid
        rings = _resume_rings(rs, local, B, init_params)
        if learning_rate is None:
            lr = np.asarray(rs["lr"], dtype=float).copy()
        if mcse_threshold is None:
            mcse_thresholds = np.asarray(rs["mcse_thresholds"], dtype=float).copy()
        R = rings[local[0]].shape[0]  # the checkpointed rings win over local sizing
        t = int(rs["t"])
        k = int(rs["k"])
        for name, arr in (("k_conv", k_conv), ("k_Rhat", k_Rhat),
                          ("k_stopped", k_stopped), ("W_check", W_check),
                          ("last_best_W", last_best_W)):
            arr[:] = np.asarray(rs[name])
        for b in range(B):
            if bool(np.asarray(rs["frozen_mask"])[b]):
                frozen[b] = torch.as_tensor(rs["frozen_avgs"][b]).to(init_params)
            if bool(np.asarray(rs["checked_mask"])[b]):
                last_checked_avg[b] = torch.as_tensor(rs["checked_avgs"][b]).to(init_params)
            if bool(np.asarray(rs["opt_stop_mask"])[b]):
                opt_stop_rows[b] = _clone_state(rs["opt_states_at_stop"][b])
        if diagnostics:
            for b in range(B):
                row = frozen[b] if frozen[b] is not None else last_checked_avg[b]
                if row is not None:
                    avg_snapshot[b] = row
        pending.extend({"k": int(ck["k"]), "windows": np.asarray(ck["windows"]),
                        "r_hats": _host_handle(ck["r_hats"])}
                       for ck in rs["pending_checks"])
        resumed_opt_time = float(rs["total_opt_time"])
        ladder.restore(rs)
    run = _RunState(var_params, opt_states, obj_states, generators, rings, lr, t)
    # the shared adaptive check cadence (FASO's rhat_backoff)
    cadence = _CheckCadence(rhat_backoff, rhat_threshold, rhat_allowed, max(1, R // k_check))
    if resume_state is not None:
        cadence.restore(resume_state)
    if diagnostics:
        # the 0-entry records the caller's init_params (FASO's trail starts
        # with init_param, also on resume)
        iter_avg_k_hist.append(0)
        iter_avg_hist.append(init_params.clone())
    loop_start = _now()

    def maybe_escalate():
        # num_mc_samples is shared, so the rung climbs only when EVERY
        # still-running restart's binding gate statistic has plateaued
        live = [b for b in range(B) if k_stopped[b] < 0]
        stats = ladder.stalled(live, k_conv >= 0)
        if stats is None:
            return
        new_S = ladder.climb(k)
        if stateful:
            run.obj_states = engine.resize_obj_states(run.obj_states, run.var_params)
        # watch the new noise regime at full cadence; converged restarts
        # recheck one W_min after the climb
        cadence.reset(k)
        for b in live:
            if k_conv[b] >= 0:
                W_check[b] = (k - k_conv[b]) + W_min
        print("MC escalation: convergence gates stalled (worst {:.3g}); "
              "num_mc_samples -> {} at iteration {}".format(max(stats), new_S, k))

    def process_check(ck, final=False):
        ck_k = int(ck["k"])
        r_hats = _read_host(ck["r_hats"])          # (B, K)
        windows = np.asarray(ck["windows"])
        best_idx = np.argmin(r_hats, axis=1)       # best window per restart
        if diagnostics:
            # every live restart's current iterate average (FASO appends
            # its average at every R-hat check in diagnostics mode)
            Wd = np.empty(B, dtype=int)
            for b in range(B):
                if k_stopped[b] >= 0:
                    Wd[b] = 1  # placeholder; the frozen row is kept below
                elif k_conv[b] >= 0:
                    Wd[b] = min(max(k - k_conv[b], 1), R, k)
                else:
                    Wd[b] = min(int(windows[best_idx[b]]) + (k - ck_k), R, k)
            avgs_d = engine.means(run.rings, run.t, Wd)
            for b in range(B):
                if k_stopped[b] < 0:
                    avg_snapshot[b] = avgs_d[b]
            iter_avg_k_hist.append(ck_k)
            iter_avg_hist.append(avg_snapshot.clone())
        best_stats = []
        for b in range(B):
            if k_conv[b] >= 0:
                continue
            best = int(best_idx[b])
            last_best_W[b] = int(windows[best])
            best_stats.append(r_hats[b, best])
            if r_hats[b, best] <= gate:
                k_Rhat[b] = ck_k
                k_conv[b] = ck_k - int(windows[best])
                W_check[b] = int(windows[best])
                if final:
                    # keep FASO's pass-time average (the window extended
                    # over the steps run while the verdict was in flight);
                    # an in-loop pass is always due for an MCSE check at
                    # once, which overwrites it
                    w_eff = min(int(windows[best]) + (k - ck_k), R, k)
                    last_checked_avg[b] = engine.mean_of(b, run.rings, run.t, w_eff)
            else:
                ladder.track_rhat(b, ck_k, r_hats[b, best])
        if best_stats:
            cadence.adjust(min(best_stats), ck_k, k)

    timed_out = False
    while k < n_iters and not np.all(k_stopped >= 0):
        # the wall-clock budget at segment boundaries (FASO's contract)
        if max_time is not None and engine.agree(_now() - loop_start) >= float(max_time):
            timed_out = True
            print("WARNING: wall-clock budget ({:g} s) reached at iteration {}; "
                  "returning partial results (resumable)".format(float(max_time), k))
            break
        steps = min(k_check - (k % k_check), n_iters - k)
        values, grads, dirs = engine.run_segment(run, steps)
        k += steps
        if stateful:
            engine.check_obj_states(run.obj_states, obj_errors, k)
        values_hist.append(values)
        if diagnostics:
            grad_hist.append(grads)
            dir_hist.append(dirs)

        if np.any(k_conv < 0) and k % k_check == 0 and cadence.due(k):
            W_upper = min(int(0.95 * k), R)
            if W_upper > W_min and W_upper >= 2 * G:
                cadence.dispatched(k, k_check)
                windows = _candidate_windows(W_min, W_upper, G)
                pending.append({"k": k, "windows": windows,
                                "r_hats": _to_host_async(
                                    engine.rhats(run.rings, run.t, windows))})
        while pending and k - int(pending[0]["k"]) >= pipeline * k_check:
            process_check(pending.popleft())
            maybe_escalate()

        due = [b for b in range(B)
               if k_conv[b] >= 0 and k_stopped[b] < 0 and k - k_conv[b] >= W_check[b]]
        if due:
            W = np.minimum(np.maximum(k - k_conv, 1), min(R, k))
            # Timer, like single-run FASO, so the B = 1 recheck growth
            # matches it under the tests' stubbed clocks
            with Timer() as mcse_timer:
                effs, mcses = engine.mcses(run.rings, run.t, W)
            mcse_interval = engine.agree(mcse_timer.interval)
            mcse_time_total += mcse_interval
            # one window-mean pass per MCSE check: stopping restarts freeze
            # it, the other due restarts keep it as their last-checked
            # average (FASO's opt_param when the gate never passes)
            avgs = engine.means(run.rings, run.t, W)
            if diagnostics:
                due_mask = np.zeros(B, dtype=bool)
                due_mask[due] = True
                mcse_k_hist.append(k)
                mcse_due_hist.append(due_mask)
                ess_hist.append(effs.copy())
                mcse_hist.append(mcses.copy())
                for b in due:
                    avg_snapshot[b] = avgs[b]
                if not iter_avg_k_hist or iter_avg_k_hist[-1] != k:
                    iter_avg_k_hist.append(k)
                    iter_avg_hist.append(avg_snapshot.clone())
            for b in due:
                if rhat_allowed is None:
                    mcse_stat = float(np.max(mcses[b]))
                    ess_stat = float(np.min(effs[b]))
                else:
                    q = float(rhat_quantile)
                    mcse_stat = float(np.quantile(mcses[b], q))
                    ess_stat = float(np.quantile(effs[b], 1.0 - q))
                if mcse_stat < mcse_thresholds[b] and ess_stat > ESS_min:
                    k_stopped[b] = k
                    frozen[b] = avgs[b]
                    opt_stop_rows[b] = _clone_state(run.opt_states[b])
                else:
                    last_checked_avg[b] = avgs[b]
                    ladder.track_mcse(b, int(W[b]) >= R, mcse_stat, mcse_thresholds[b],
                                      ess_stat, ESS_min)
                    total_opt = resumed_opt_time + max(
                        engine.agree(_now() - loop_start) - mcse_time_total, 1e-9)
                    W_check[b] = int(_recheck_scale(
                        total_opt / k, mcse_interval / int(W[b])) * W_check[b] + 1)
            maybe_escalate()

    # each stopped restart's step-rule state as of its own stop; the
    # others' end-of-run state
    # (each from the rank that steps it)
    opt_states_at_stop = engine.gather_list(
        [row if row is not None else st for row, st in zip(opt_stop_rows, run.opt_states)],
        device)
    final_params = engine.gather_rows(torch.stack([run.var_params[b] for b in local]))
    # snapshot the in-flight checks before draining them, like FASO: a
    # resumed run replays them on the same schedule
    zero_row = torch.zeros(D, dtype=dtype, device=device)
    resume_snapshot = {
        "var_params": final_params,
        "opt_states": engine.gather_list(run.opt_states, device),
        "obj_states": engine.gather_list(run.obj_states, device),
        "generator_states": torch.stack(engine.gather_list(
            [g.get_state() for g in run.generators])),
        "lr": run.lr.copy(),
        "mcse_thresholds": mcse_thresholds.copy(),
        "rings": [run.rings[b] for b in local],
        **_ring_span(restarts, local, B),
        "t": run.t,
        "k": k,
        "k_conv": k_conv.copy(),
        "k_Rhat": k_Rhat.copy(),
        "k_stopped": k_stopped.copy(),
        "W_check": W_check.copy(),
        "last_best_W": last_best_W.copy(),
        "frozen_avgs": torch.stack([zero_row if f is None else f for f in frozen]),
        "frozen_mask": np.array([f is not None for f in frozen]),
        "opt_states_at_stop": opt_states_at_stop,
        "opt_stop_mask": np.array([r is not None for r in opt_stop_rows]),
        "checked_avgs": torch.stack([zero_row if a is None else a
                                     for a in last_checked_avg]),
        "checked_mask": np.array([a is not None for a in last_checked_avg]),
        "pending_checks": [{"k": int(ck["k"]), "windows": np.asarray(ck["windows"]),
                            "r_hats": _read_host(ck["r_hats"])} for ck in pending],
        **cadence.state(),
        "total_opt_time": resumed_opt_time + (engine.agree(_now() - loop_start)
                                              - mcse_time_total),
        **ladder.state(),
    }
    while pending:
        process_check(pending.popleft(), final=True)
        maybe_escalate()

    # final averages (FASO's non-diagnostics opt_param, per restart): frozen
    # at its own stop; else the last MCSE check's; else the converged or
    # best-R-hat window mean; else the initial parameter
    if diagnostics:
        # the iterate average at the last recorded check, like FASO
        opt_param = avg_snapshot
    else:
        needs_final = [b for b in range(B)
                       if frozen[b] is None and last_checked_avg[b] is None
                       and (k_conv[b] >= 0 or last_best_W[b] > 0)]
        W_final = np.where(k_conv >= 0, np.maximum(k - k_conv, 1),
                           np.maximum(last_best_W, 1)).astype(int)
        W_final = np.minimum(W_final, min(R, max(k, 1)))
        final_rows = engine.mean_rows(run.rings, {b: (run.t, int(W_final[b]))
                                                  for b in needs_final})
        rows = []
        for b in range(B):
            if frozen[b] is not None:
                rows.append(frozen[b])
            elif last_checked_avg[b] is not None:
                rows.append(last_checked_avg[b])
            elif b in needs_final:
                rows.append(final_rows[b])
            else:
                rows.append(init_params[b])
        opt_param = torch.stack(rows)
    results = {
        "opt_param": opt_param,
        "final_param": final_params,
        "value_history": (torch.cat(values_hist, dim=1) if values_hist
                          else torch.zeros((B, 0), dtype=dtype, device=device)),
        "k_conv": [None if v < 0 else int(v) for v in k_conv],
        "k_Rhat": [None if v < 0 else int(v) for v in k_Rhat],
        "k_stopped": [None if v < 0 else int(v) for v in k_stopped],
        "timed_out": timed_out,
        "opt_states_at_stop": opt_states_at_stop,
        "resume_state": resume_snapshot,
    }
    if ladder.escalation is not None:
        results["mc_escalation_history"] = _events_array(ladder.events)
    if stateful:
        results["obj_state_errors"] = engine.gather_list(obj_errors)
    if diagnostics:
        empty = np.zeros((B, 0, D), dtype=init_params.cpu().numpy().dtype)
        results["grad_history"] = np.concatenate(grad_hist, axis=1) if grad_hist else empty
        results["descent_dir_history"] = (np.concatenate(dir_hist, axis=1)
                                          if dir_hist else empty)
        results["iterate_average_k_history"] = np.asarray(iter_avg_k_hist)
        results["iterate_average_history"] = torch.stack(iter_avg_hist)
        # the four MCSE-trail keys appear together or not at all, like FASO
        if mcse_k_hist:
            results["ess_and_mcse_k_history"] = np.asarray(mcse_k_hist)
            results["ess_due_history"] = np.stack(mcse_due_hist)
            results["ess_history"] = np.stack(ess_hist)
            results["mcse_history"] = np.stack(mcse_hist)
    return results
