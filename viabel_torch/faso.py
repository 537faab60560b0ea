"""FASO and RAABBVI meta-optimizers (counterpart of ``viabel_tpu/faso.py``;
reference ``viabel/optimization.py`` FASO 479-633, RAABBVI 635-931;
Welandawe, Andersen, Vehtari & Huggins, JMLR 2024).

The per-step optimization runs in *segments* of ``k_check`` steps that
write iterates into a fixed-size ``(R, D)`` history ring on the device;
the data-dependent control (R-hat window search, MCSE recheck schedule,
learning-rate decay, termination) runs on the host between segments.
A segment is a Python loop of device steps; where the route allows it
(:func:`viabel_torch.optimizers.graph_refusal`), each step past two
warm-up steps at a sample count is one replay of a CUDA graph of the whole
step (:class:`viabel_torch.optimizers._GraphedStep`), which draws,
computes and updates exactly as the eager step does; host values the step
reads are those of the capture.

R-hat checks are pipelined as in the JAX package: each check is launched
on the device at once and its ``(K,)`` result copied to pinned host memory
without blocking; the verdict is read ``check_pipeline`` segments later,
when the copy has long finished, and convergence is back-dated to the
check's own iteration.

Every run returns a ``resume_state`` that continues it from its last
segment boundary (save it with :mod:`viabel_torch.checkpoint`), and
``max_time`` stops a run at a segment boundary with ``timed_out`` set. In
place of the JAX package's PRNG key the state carries the generator's
``get_state()``; a resumed run sets it into the caller's generator, which
must be on the same device type. Over an MC-sharded objective
(:func:`viabel_torch.parallel.shard_mc_objective`) every rank runs this
loop; the decisions that read the wall clock (``max_time`` and the MCSE
recheck schedule) are rank 0's, through the objective's ``agree``.

``FASO(mesh=..., shard_axis=...)`` splits the ring's columns over a mesh
axis (:func:`viabel_torch.parallel.mesh.column_split`): each rank keeps
its own contiguous ``(R, D_r)`` shard, writes its columns of the
replicated iterate, and runs the statistics (kernel 1 included) on its
shard. Only the reductions cross ranks: a MAX of the windows' R-hat (a
SUM of the quantile gate's counts), a MAX of MCSE and a MIN of ESS, and
an all-gather of the window means, so every rank returns the whole
vector. The clock readings are rank 0's over the axis. A rank whose shard
has no column (fewer columns than ranks) launches nothing: its R-hat and
MCSE enter the reductions as their identities.

A resume state resumes on any mesh shape: a whole ring (``ring_columns``
``[0, D, D]``, or none) is cut to this rank's columns, and the per-rank
states of a sharded run are joined into the whole one first by
:func:`merge_resume_states` (the JAX package re-shards its global ring
with ``device_put``).
"""

import math
from collections import defaultdict, deque

import numpy as np
import torch

from .detection import (_candidate_windows, _CheckCadence, _detection_geometry,
                        _events_array, _host_handle, _MCLadder, _mcse_check, _read_host,
                        _recheck_scale, _restore_rounds_ladder, _rounds_ladder_state,
                        _to_host_async)
from .families import MFGaussian
from .mc_diagnostics import ring_window_mean, split_rhat_ring_windows
from .ops.wlr import wlr_hmc
from .optimizers import (AveragedAdam, AveragedRMSProp, Optimizer, RMSProp,
                         StochasticGradientOptimizer, _GraphedStep, _obj_check_state,
                         _obj_init_state, default_generator, graph_refusal)
from .tracing import span
from .utils import Timer, _clone_state, _int_list, _now, _set_generator_state, check_device

__all__ = ["FASO", "RAABBVI", "merge_resume_states"]

def _resume_ring(rs, c0, c1, D, like):
    """Columns ``[c0, c1)`` of a FASO resume state's ``(R, D)`` ring, as a
    contiguous copy on ``like``'s device and dtype (segments write the
    ring in place, and the caller's snapshot must stay valid). The state's
    ring is whole or exactly this shard; a state that holds another
    rank's shard, or belongs to another ``D``, raises ``ValueError``."""
    ring = torch.as_tensor(rs["ring"])
    width = ring.shape[1]
    a, b, D_saved = _int_list(rs.get("ring_columns", (0, width, width)))
    if D_saved != D or b - a != width:
        raise ValueError(f"resume_state's ring holds columns [{a}, {b}) of {D_saved}; "
                         f"this run has {D} coordinates")
    if (a, b) == (0, D):
        ring = ring[:, c0:c1]
    elif (a, b) != (c0, c1):
        raise ValueError(
            f"resume_state's ring holds columns [{a}, {b}) of {D}, one rank's shard, and "
            f"this rank's are [{c0}, {c1}): join every rank's state with "
            "merge_resume_states first")
    return ring.to(device=like.device, dtype=like.dtype, copy=True,
                   memory_format=torch.contiguous_format)


def merge_resume_states(states):
    """The whole resume state of a run sharded over ranks, from every
    rank's ``results["resume_state"]`` (in any order).

    FASO's ring shards (``ring_columns``) are joined along their columns
    and the multistart engines' rings (``ring_restarts``) in restart
    order; a shard that two ranks hold alike (a replica over another mesh
    axis) enters once. Every other leaf is the same on every rank and is
    taken from the first state; nested states (RAABBVI's ``flight``, the
    async prelude's ``prelude_flight``) are joined alike. The result
    resumes the run on any mesh shape, or without a mesh. States that do
    not cover the whole ring, or belong to different runs, raise
    ``ValueError``.
    """
    states = list(states)
    first = states[0]
    if not isinstance(first, dict):
        return first
    for span_key, ring_key in (("ring_columns", "ring"), ("ring_restarts", "rings")):
        if span_key not in first:
            continue
        spans = [tuple(_int_list(st[span_key])) for st in states]
        total = spans[0][2]
        parts, pos, last = [], 0, None
        for (a, b, n), st in sorted(zip(spans, states), key=lambda p: p[0]):
            if n != total:
                raise ValueError(f"states of {total} and {n} {ring_key} columns or rows "
                                 "belong to different runs")
            if a == pos:
                parts.append(st[ring_key])
                pos = b
            elif (a, b) != last:
                raise ValueError(f"the states' {span_key} {sorted(spans)} do not tile "
                                 f"[0, {total})")
            last = (a, b)
        if pos != total:
            raise ValueError(f"the states cover [0, {pos}) of {total}: every rank's "
                             "state is needed")
        whole = dict(first)
        whole[ring_key] = (torch.cat([torch.as_tensor(p) for p in parts], dim=1)
                           if ring_key == "ring" else [r for p in parts for r in p])
        whole[span_key] = np.asarray([0, total, total])
        return whole
    return {k: merge_resume_states([st[k] for st in states]) if isinstance(v, dict) else v
            for k, v in first.items()}


def _agreed(objective, x):
    """``x``, or rank 0's reading of it when the objective is sharded over
    ranks (``agree``): every rank runs its own copy of the loop, and a
    decision that reads the wall clock must be taken alike on all of them.
    """
    agree = getattr(objective, "agree", None)
    return x if agree is None else agree(x)


class FASO(Optimizer):
    """Fixed-learning-rate stochastic optimization with convergence
    detection (reference optimization.py:479-633).

    The parameters are those of :class:`viabel_tpu.FASO` (see its
    docstring for each knob's measured rationale): ``mcse_threshold``,
    ``W_min``, ``ESS_min``, ``k_check`` (check cadence and segment
    length), ``max_history`` (ring rows; ``None`` sizes it to
    ``n_iters``), ``rhat_threshold``, ``rhat_quantile``, ``rhat_backoff``,
    ``rhat_group``, ``check_pipeline`` (segments between an R-hat check's
    dispatch and its read-back; diagnostics mode reads at once),
    ``max_time`` (a wall-clock budget in seconds for each ``optimize``
    call, checked at segment boundaries), ``mc_escalation``,
    ``mc_max_samples``, ``mc_patience``, ``mc_plateau_rtol``; ``mesh``
    and ``shard_axis`` split the history ring's columns over that axis of
    a ``DeviceMesh`` (see the module docstring). Every rank of the mesh
    runs ``optimize`` with the same arguments and generator seed; the
    results are the same on every rank and equal the unsharded run's.
    A ``resume_state`` resumes on any mesh shape: pass the whole state
    (an unsharded run's, or the ranks' states joined by
    :func:`merge_resume_states`), or this rank's own state of a run on
    the same mesh.

    Beside the JAX package's results, ``results["rhat_verdicts"]`` lists
    each R-hat verdict read as ``(k, best_window, statistic, passed)``.

    On a CUDA device the steps replay CUDA graphs where the step rule, the
    objective, its family and its model state they are safe to
    (:func:`viabel_torch.optimizers.graph_refusal`). A replayed step reads
    the host values of its capture: a Python attribute of the model or the
    family changed between steps, or between two ``optimize`` calls on the
    same objects, is not seen, as under the JAX package's ``jit``. The
    sample count, the learning rate and a swapped model are seen.
    """

    def __init__(self, sgo, *, mcse_threshold=0.1, W_min=200, ESS_min=None,
                 k_check=None, max_history=None, rhat_threshold=1.1,
                 rhat_quantile=None, rhat_backoff=None, rhat_group=None,
                 check_pipeline=4, mesh=None, shard_axis="mc", max_time=None,
                 mc_escalation=None, mc_max_samples=None, mc_patience=3,
                 mc_plateau_rtol=0.05):
        if not isinstance(sgo, StochasticGradientOptimizer):
            raise ValueError("sgo must be a subclass of StochasticGradientOptimizer")
        self._sgo = sgo
        self._graphed = None  # the _GraphedStep of the last segment that had one
        self._mesh = mesh
        self._shard_axis = shard_axis
        self._mcse_threshold = float(mcse_threshold)
        self._W_min = int(W_min)
        self._ESS_min = W_min // 8 if ESS_min is None else ESS_min
        self._k_check = int(W_min if k_check is None else k_check)
        self._max_history = max_history
        self._rhat_threshold = float(rhat_threshold)
        self._rhat_quantile = None if rhat_quantile is None else float(rhat_quantile)
        self._rhat_backoff = None if rhat_backoff is None else float(rhat_backoff)
        self._rhat_group = int(rhat_group) if rhat_group else None
        self._check_pipeline = int(check_pipeline)
        self._max_time = None if max_time is None else float(max_time)
        self._mc_escalation = (None if mc_escalation is None
                               else float(mc_escalation))
        self._mc_max_samples = (None if mc_max_samples is None
                                else int(mc_max_samples))
        self._mc_patience = int(mc_patience)
        self._mc_plateau_rtol = float(mc_plateau_rtol)
        _MCLadder.check_args(self._mc_escalation, self._mc_max_samples,
                             self._mc_patience, self._mc_plateau_rtol)
        if self._max_time is not None and self._max_time < 0:
            raise ValueError('"max_time" must be non-negative')
        if self._check_pipeline < 0:
            raise ValueError('"check_pipeline" must be non-negative')
        if mcse_threshold <= 0:
            raise ValueError('"mcse_threshold" must be greater than zero')
        if W_min <= 0:
            raise ValueError('"W_min" must be greater than zero')
        if self._k_check <= 0:
            raise ValueError('"k_check" must be greater than zero')
        if self._ESS_min <= 0:
            raise ValueError('"ESS_min" must be greater than zero')
        # shared validation of rhat_quantile / rhat_backoff / rhat_group
        _detection_geometry(1, self._W_min, self._k_check, self._ESS_min,
                            self._rhat_group, self._rhat_quantile,
                            self._rhat_backoff, 1)

    def _graphed_step(self, objective, var_param, obj_state, generator):
        """The helper that replays a segment's steps from CUDA graphs, kept
        from segment to segment and from call to call while it serves the
        same step rule, objective, model and generator; None where the
        steps run eagerly (:func:`~viabel_torch.optimizers.graph_refusal`).
        Host values a replayed step reads are those of its capture."""
        if graph_refusal(self._sgo, objective, var_param, obj_state,
                         self._mesh) is not None:
            return None
        if self._graphed is None or not self._graphed.serves(
                self._sgo, objective, var_param, generator):
            self._graphed = _GraphedStep(self._sgo, objective, var_param, generator)
        return self._graphed

    def _run_segment(self, objective, var_param, opt_state, obj_state, generator,
                     ring, t, lr, steps, diagnostics, cols=slice(None)):
        """``steps`` optimizer steps, each iterate's columns ``cols`` (the
        ring's shard) written to ring slot ``t % R``. Returns the carry and
        the segment's outputs (values, and per-step gradients and
        directions on the host in diagnostics mode). Where the route allows
        it (:meth:`_graphed_step`), the steps replay CUDA graphs."""
        R = ring.shape[0]
        values, grads, dirs = [], [], []
        graphed = self._graphed_step(objective, var_param, obj_state, generator)
        for _ in range(steps):
            with span("viabel.step"):
                if graphed is None:
                    var_param, opt_state, obj_state, value, direction, grad = self._sgo.step(
                        objective, var_param, opt_state, obj_state, generator, lr)
                else:
                    var_param, opt_state, value = graphed.step(var_param, opt_state, lr)
                ring[t % R] = var_param[cols]
            t += 1
            values.append(value)
            if diagnostics:
                grads.append(grad)
                dirs.append(direction)
        if graphed is not None:
            var_param, opt_state = graphed.release(var_param, opt_state)
        outs = (torch.stack(values),)
        if diagnostics:
            outs += (torch.stack(grads).cpu().numpy(),
                     torch.stack(dirs).cpu().numpy())
        return var_param, opt_state, obj_state, t, outs

    def optimize(self, n_iters, objective, init_param, generator=None,
                 init_opt_state=None, resume_state=None,
                 progress_callback=None, learning_rate=None,
                 mcse_threshold=None, max_time=None):
        """Run FASO.

        ``resume_state``: the ``results["resume_state"]`` of an earlier
        (possibly stopped) run; the run continues from that segment
        boundary with the same convergence statistics, and the
        ``generator_state`` it carries is set into ``generator`` (by
        default a new generator on the parameter's device), which must be
        on the same device type as the generator that saved it.
        ``progress_callback(k, avg_loss)`` is invoked at each segment
        boundary. ``learning_rate`` / ``mcse_threshold`` / ``max_time``
        override the constructor values for this run only (RAABBVI threads
        its per-round decayed values and the rest of its budget through
        them).
        """
        n_iters = int(n_iters)
        max_time = self._max_time if max_time is None else float(max_time)
        mcse_threshold = (self._mcse_threshold if mcse_threshold is None
                          else float(mcse_threshold))
        diagnostics = self._sgo._diagnostics
        mf_dim = (objective.approx.dim
                  if isinstance(getattr(objective, "approx", None), MFGaussian)
                  else None)

        var_param = init_param.detach().clone()
        D = var_param.shape[0]
        # the detection geometry reads the global D (the quantile gate's
        # allowed count among them)
        _, _, G, R, rhat_allowed = _detection_geometry(
            D, self._W_min, self._k_check, self._ESS_min, self._rhat_group,
            self._rhat_quantile, self._rhat_backoff,
            int(self._max_history) if self._max_history else max(n_iters, 2))
        shard, c0, c1, gather = None, 0, D, None
        if self._mesh is not None:
            from .parallel.mesh import MeshAxis, column_split
            shard = MeshAxis(self._mesh, self._shard_axis)
            bounds = column_split(D, shard.n, var_param.dtype)
            c0, c1 = bounds[shard.coordinate], bounds[shard.coordinate + 1]
            widths = np.diff(bounds).tolist()

            def gather(x):
                return shard.gather(x, widths)

        cols = slice(c0, c1)
        # a shard with no column (D below the rank count) reads no ring
        empty = c1 == c0

        def window_mean(w):
            """The whole ``(D,)`` mean of the ring's last ``w`` iterates."""
            mean = ring.new_zeros(0) if empty else ring_window_mean(ring, t, w, G)
            return mean if gather is None else gather(mean)

        def ring_rhats(windows):
            """The ``(K,)`` R-hat statistics of this rank's columns; the
            identity of their reduction over ranks on an empty shard."""
            if empty:
                return torch.full((len(windows),), -torch.inf if rhat_allowed is None
                                  else 0.0, dtype=ring.dtype, device=ring.device)
            return split_rhat_ring_windows(
                ring, t, windows, G, exceed_threshold=(None if rhat_allowed is None
                                                       else self._rhat_threshold))

        def agreed(x):
            x = _agreed(objective, x)
            return x if shard is None else shard.agree(x)

        # a resumed run brings its own ring
        ring = (torch.zeros((R, c1 - c0), dtype=var_param.dtype, device=var_param.device)
                if resume_state is None else None)
        opt_state = (self._sgo.init_state(var_param)
                     if init_opt_state is None else init_opt_state)
        obj_state = _obj_init_state(objective, var_param)
        t = 0
        lr = float(self._sgo._learning_rate if learning_rate is None
                   else learning_rate)

        # the ceiling and the event log are sized from the entry S
        ladder = _MCLadder(objective, 1, self._mc_escalation, self._mc_max_samples,
                           self._mc_patience, self._mc_plateau_rtol, flat=True)
        # an objective with estimator state escalates too: the rung
        # boundary re-derives its state at the new sample count
        mc_stateful = bool(obj_state)

        history = defaultdict(list)
        iterate_average = var_param
        if diagnostics:
            history["iterate_average_k_history"].append(0)
            history["iterate_average_history"].append(iterate_average)

        k = 0
        k_conv = None   # iteration when stationarity was reached (back-dated)
        k_Rhat = None   # iteration when the R-hat criterion was met
        k_stopped = None
        W_check = None
        last_best_W = None  # best R-hat window at the most recent check
        total_opt_time = 0.0
        eff = mcse = None
        pending = deque()

        if resume_state is not None:
            rs = resume_state
            var_param = torch.as_tensor(rs["var_param"]).to(var_param).clone()
            opt_state = _clone_state(rs["opt_state"])
            obj_state = _clone_state(rs.get("obj_state", obj_state))
            ring = _resume_ring(rs, c0, c1, D, var_param)
            R = ring.shape[0]  # the checkpointed ring wins over local sizing
            t = int(rs["t"])
            k = int(rs["k"])
            k_conv = None if int(rs["k_conv"]) < 0 else int(rs["k_conv"])
            k_Rhat = None if int(rs["k_Rhat"]) < 0 else int(rs["k_Rhat"])
            W_check = None if int(rs["W_check"]) < 0 else int(rs["W_check"])
            total_opt_time = float(rs["total_opt_time"])
            iterate_average = torch.as_tensor(rs["iterate_average"]).to(var_param)
            pending.extend({"k": int(ck["k"]), "windows": np.asarray(ck["windows"]),
                            "r_hats": _host_handle(ck["r_hats"])}
                           for ck in rs.get("pending_checks", []))
            ladder.restore(rs)
        if generator is None:
            generator = default_generator(var_param.device)
        if resume_state is not None and "generator_state" in resume_state:
            _set_generator_state(generator, resume_state["generator_state"])

        # fixed-lr segments are identical whatever a pending R-hat check
        # concludes, so verdicts are read `pipeline` segments after their
        # dispatch; diagnostics mode reads them at once so per-check
        # histories match the reference exactly
        pipeline = 0 if diagnostics else self._check_pipeline
        # the adaptive check cadence; its backoff cap keeps consecutive
        # checks within one ring length
        cadence = _CheckCadence(self._rhat_backoff, self._rhat_threshold, rhat_allowed,
                                max(1, R // self._k_check))
        if resume_state is not None:
            cadence.restore(resume_state)
        timed_out = False
        resumed_opt_time = total_opt_time
        mcse_time_total = 0.0
        loop_start = _now()

        def process_check(ck):
            nonlocal k_Rhat, k_conv, W_check, last_best_W, iterate_average
            with span("viabel.faso.rhat_readback"):
                ck_k = int(ck["k"])
                r_hats = _read_host(ck["r_hats"])
                best = int(np.argmin(r_hats))
                best_W = int(ck["windows"][best])
                last_best_W = best_W
                cadence.adjust(r_hats[best], ck_k, k)
                # max mode: r_hats are max-R-hat values, gated by threshold;
                # quantile mode: above-threshold coordinate counts
                passed = bool(r_hats[best] <= (self._rhat_threshold
                                               if rhat_allowed is None
                                               else rhat_allowed))
                history["rhat_verdicts"].append(
                    (ck_k, best_W, float(r_hats[best]), passed))
                if diagnostics or passed:
                    # the average covers [ck.k - best_W, k): what a synchronous
                    # check at k would produce after back-dating
                    w_eff = min(best_W + (k - ck_k), R, k)
                    iterate_average = window_mean(w_eff)
                if diagnostics:
                    history["iterate_average_k_history"].append(ck_k)
                    history["iterate_average_history"].append(iterate_average)
                if passed:
                    k_Rhat = ck_k
                    k_conv = ck_k - best_W
                    W_check = best_W  # immediately check MCSE
                else:
                    # gradient-SNR escalation: the gate is failing and the best
                    # statistic has stopped improving
                    ladder.track_rhat(0, ck_k, r_hats[best])
                    escalate_if_stalled()
                return passed

        def escalate_if_stalled():
            nonlocal obj_state, W_check
            stats = ladder.stalled([0], [k_conv is not None])
            if stats is None:
                return
            with span("viabel.faso.escalate"):
                new_S = ladder.climb(k)
                if mc_stateful:
                    # re-derive the threaded estimator state at the new count
                    resize = getattr(objective, "resize_obj_state", None)
                    obj_state = (resize(obj_state, var_param) if resize is not None
                                 else _obj_init_state(objective, var_param))
                # watch the new noise regime at full cadence
                cadence.reset(k)
                if k_conv is not None:
                    # the MCSE recheck schedule was calibrated to the old noise
                    # regime: recheck one W_min after the escalation instead
                    W_check = (k - k_conv) + self._W_min
                print("MC escalation: convergence gate stalled at {:.3g}; "
                      "num_mc_samples -> {} at iteration {}".format(
                          float(stats[0]), new_S, k))

        while k < n_iters:
            # the wall-clock budget is enforced at segment boundaries, so a
            # timed-out run stops exactly where a resume can continue it
            if max_time is not None and agreed(_now() - loop_start) >= max_time:
                timed_out = True
                print("WARNING: wall-clock budget ({:g} s) reached at "
                      "iteration {}; returning partial results "
                      "(resumable)".format(max_time, k))
                break
            # segments stay aligned to the k_check grid (a resumed run's
            # first segment may be shorter to realign)
            steps = min(self._k_check - (k % self._k_check), n_iters - k)
            with span("viabel.faso.segment"):
                var_param, opt_state, obj_state, t, outs = self._run_segment(
                    objective, var_param, opt_state, obj_state, generator, ring, t,
                    lr, steps, diagnostics, cols)
            _obj_check_state(objective, obj_state)
            k += steps
            history["value_history"].append(outs[0])
            if diagnostics:
                history["grad_history"].append(outs[1])
                history["descent_dir_history"].append(outs[2])
            if progress_callback is not None:
                progress_callback(k, float(outs[0].mean()))

            # R-hat convergence check (reference optimization.py:550-563):
            # launch the one-ring-read statistic now, read the verdict
            # `pipeline` segments later
            if k_conv is None and k % self._k_check == 0 and cadence.due(k):
                W_upper = min(int(0.95 * k), R)
                if W_upper > self._W_min and W_upper >= 2 * G:
                    cadence.dispatched(k, self._k_check)
                    windows = _candidate_windows(self._W_min, W_upper, G)
                    with span("viabel.faso.rhat_dispatch"):
                        r_hats = ring_rhats(windows)
                        if shard is not None:
                            # on the device, before the pipelined read-back
                            r_hats = (shard.max(r_hats) if rhat_allowed is None
                                      else shard.sum(r_hats))
                        pending.append({"k": k, "windows": windows,
                                        "r_hats": _to_host_async(r_hats)})
            # read verdicts at least `pipeline` segments old (by dispatch
            # age, so a backed-off schedule doesn't stretch the lag)
            while pending and k - int(pending[0]["k"]) >= pipeline * self._k_check:
                if process_check(pending.popleft()):
                    pending.clear()
                    break

            # MCSE / ESS stopping check (reference optimization.py:566-605)
            if k_conv is not None and k - k_conv >= W_check:
                W = min(k - k_conv, R, k)
                iterate_average = window_mean(W)
                if diagnostics and (not history["iterate_average_k_history"]
                                    or history["iterate_average_k_history"][-1] != k):
                    history["iterate_average_k_history"].append(k)
                    history["iterate_average_history"].append(iterate_average)
                with span("viabel.faso.mcse_check"), Timer() as mcse_timer:
                    eff, mcse = _mcse_check(ring, t, W, mf_dim, c0=c0, gather=gather)
                    whole = shard is None or diagnostics or self._rhat_quantile is not None
                    if whole:
                        if shard is not None:
                            eff, mcse = gather(eff), gather(mcse)
                        eff = eff.cpu().numpy()
                        mcse = mcse.cpu().numpy()
                    else:
                        # one MAX over the shards: the max MCSE and the min
                        # ESS, standing in for the whole vectors below
                        worst = (shard.max(torch.stack([mcse.max(), -eff.min()]))
                                 if not empty else shard.max(torch.full(
                                     (2,), -torch.inf, dtype=ring.dtype,
                                     device=ring.device)))
                        worst = worst.cpu().numpy()
                        mcse, eff = worst[:1], -worst[1:]
                mcse_time_total += mcse_timer.interval
                if diagnostics:
                    history["ess_and_mcse_k_history"].append(k)
                    history["ess_history"].append(eff)
                    history["mcse_history"].append(mcse)
                if self._rhat_quantile is None:
                    mcse_stat = float(np.max(mcse))
                    ess_stat = float(np.min(eff))
                else:
                    q = self._rhat_quantile
                    mcse_stat = float(np.quantile(mcse, q))
                    ess_stat = float(np.quantile(eff, 1.0 - q))
                if mcse_stat < mcse_threshold and ess_stat > self._ESS_min:
                    k_stopped = k
                    break
                # (the climb is decided after the recheck growth below, so
                # its recheck reset wins)
                ladder.track_mcse(0, W >= R, mcse_stat, mcse_threshold, ess_stat,
                                  self._ESS_min)
                # cost-aware recheck growth (reference 601-605);
                # optimization time is wall-clock minus check time
                total_opt_time = resumed_opt_time + max(
                    _now() - loop_start - mcse_time_total, 1e-9)
                W_check = int(agreed(int(
                    _recheck_scale(total_opt_time / k, mcse_timer.interval / W)
                    * W_check + 1)))
                escalate_if_stalled()

        total_opt_time = resumed_opt_time + (_now() - loop_start - mcse_time_total)

        # snapshot the in-flight checks before draining them: a resumed run
        # replays them on the same schedule, so resume matches an
        # uninterrupted run (the drain below shapes only this run's
        # results); the verdicts go out as host arrays
        resume_pre_drain = {
            "k_conv": -1 if k_conv is None else k_conv,
            "k_Rhat": -1 if k_Rhat is None else k_Rhat,
            "W_check": -1 if W_check is None else W_check,
            **cadence.state(),
            "iterate_average": iterate_average,
            "pending_checks": [
                {"k": int(ck["k"]), "windows": np.asarray(ck["windows"]),
                 "r_hats": _read_host(ck["r_hats"])} for ck in pending],
            **ladder.state(),
        }
        while pending:
            if process_check(pending.popleft()):
                pending.clear()

        if k_conv is None and last_best_W is not None and not diagnostics:
            # R-hat never passed and the per-check average was deferred:
            # compute the best-window average once so opt_param matches
            # the reference (optimization.py:556, 632)
            iterate_average = window_mean(last_best_W)

        if k_stopped is not None:
            print("Convergence reached at iteration", k_stopped)
        elif not timed_out:
            if k_conv is None:
                print("WARNING: stationarity not reached after maximum number "
                      "of iterations")
                print("WARNING: consider raising the learning rate or the "
                      "maximum number of iterations")
            else:
                print("WARNING: stationarity reached but MCSE too large and/or "
                      "ESS too small")
                if mcse is not None:
                    print("WARNING: maximum MCSE = {:.3g}".format(np.max(mcse)))
                    print("WARNING: minimum ESS = {:.1f}".format(np.min(eff)))

        results = {}
        for name, h in history.items():
            if name == "value_history":
                results[name] = torch.cat(h)
            elif name in ("grad_history", "descent_dir_history"):
                results[name] = np.concatenate(h)
            elif name == "iterate_average_history":
                results[name] = torch.stack(h)
            elif name == "rhat_verdicts":
                results[name] = h
            else:
                results[name] = np.asarray(h)
        results.setdefault("rhat_verdicts", [])
        results["k_conv"] = k_conv
        results["k_Rhat"] = k_Rhat
        results["k_stopped"] = k_stopped
        results["timed_out"] = timed_out
        if ladder.escalation is not None:
            results["mc_escalation_history"] = _events_array(ladder.events)
        results["opt_param"] = iterate_average
        results["opt_state"] = opt_state
        results["resume_state"] = {
            "var_param": var_param,
            "opt_state": opt_state,
            "obj_state": obj_state,
            "generator_state": generator.get_state(),
            "ring": ring,
            "t": t,
            "k": k,
            "total_opt_time": total_opt_time,
            **resume_pre_drain,
        }
        if shard is not None:
            # the ring is this rank's shard: its columns and the global D
            results["resume_state"]["ring_columns"] = np.asarray([c0, c1, D])
        return results


class RAABBVI(FASO):
    """Robust, automated, and accurate BBVI (reference optimization.py:635-931).

    Wraps FASO rounds at geometrically decaying learning rates; terminates
    when the predicted benefit of a further decay (symmetrized-KL gap,
    estimated by Bayesian weighted regression of ``log SKL`` on ``log lr``)
    no longer justifies the predicted iteration cost. With
    ``init_rmsprop=True`` the first round is a warm start with plain
    ``RMSProp`` under a default ``FASO`` (reference optimization.py:815-818).
    """

    def __init__(self, sgo, *, rho=0.5, iters0=1000, accuracy_threshold=0.1,
                 inefficiency_threshold=1.0, init_rmsprop=False, **kwargs):
        super().__init__(sgo, **kwargs)
        self._iters0 = int(iters0)
        self._rho = float(rho)
        self._accuracy_threshold = float(accuracy_threshold)
        self._inefficiency_threshold = float(inefficiency_threshold)
        self._init_rmsprop = bool(init_rmsprop)
        if rho < 0 or rho > 1:
            raise ValueError('"rho" must be between zero and one')

    def _averaged_sgo(self):
        return isinstance(self._sgo, (AveragedRMSProp, AveragedAdam))

    def weighted_linear_regression(self, y, x, s=9.0, a=0.25, n_chains=4,
                                   generator=None, device="cuda"):
        """Bayesian weighted regression of ``log SKL`` on ``log lr``
        (the reference's Stan programs, sampled by HMC through
        :func:`viabel_torch.ops.wlr_hmc`): weights ``w_n = 1/(1 +
        rev_idx^2/s)^a`` (reference optimization.py:711). The run goes to
        ``generator``'s device (one kernel launch on a card); ``device``
        places the seed-0 generator made when none is given.

        Returns ``(fit_samples_dict, kappa, c)``.
        """
        if generator is None:
            generator = default_generator(check_device(device))
        device = generator.device
        y = np.asarray(y, dtype=float)
        x = np.asarray(x, dtype=float)
        N = y.shape[0]
        w = 1.0 / (1.0 + np.arange(N - 1, -1, -1, dtype=float) ** 2 / s) ** a
        if self._averaged_sgo():
            init = [float(np.mean(y)), 0.0]
        else:
            kappa0 = 0.8
            log_c0 = (float(np.mean(y)) - 2.0 * math.log(self._rho ** (-kappa0) - 1.0)
                      - 2.0 * kappa0 * float(np.mean(x)))
            init = [math.log(kappa0 / (1 - kappa0)), log_c0, 0.0]
        with span("viabel.raabbvi.regression"):
            # one host-to-device copy of the rows
            y_t, x_t, w_t = torch.as_tensor(np.stack([y, x, w]), device=device)
            init = torch.tensor(init, dtype=y_t.dtype, device=device).repeat(n_chains, 1)
            samples = wlr_hmc(init, generator, (y_t, x_t, w_t, self._rho))
            flat = samples.reshape(-1, samples.shape[-1])
            if self._averaged_sgo():
                fit = {"log_c": flat[:, 0], "sigma": torch.exp(flat[:, 1])}
                kappa, log_c = 1.0, float(fit["log_c"].mean())
            else:
                fit = {"kappa": torch.sigmoid(flat[:, 0]), "log_c": flat[:, 1],
                       "sigma": torch.exp(flat[:, 2])}
                kappa, log_c = torch.stack([fit["kappa"].mean(),
                                            fit["log_c"].mean()]).tolist()
        return fit, kappa, float(np.exp(log_c))

    @staticmethod
    def wls(x, y, s=9.0, a=0.25):
        """Closed-form weighted least squares (reference optimization.py:728-755)."""
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        n = y.size
        X = np.column_stack((np.ones(n), x))
        w = 1.0 / (1.0 + np.arange(n)[::-1] ** 2 / s**2) ** a
        XtW = X.T * w
        beta = np.linalg.solve(XtW @ X, XtW @ y)
        return beta[0], beta[1]

    @staticmethod
    def convg_iteration_trend_detection(slope):
        """Negative lr-vs-iterations trend? (reference optimization.py:757-776)."""
        return slope < 0

    def skl_round_update(self, approx, avg_prev, avg_curr, *, skl_hist,
                         lr_hist, conv_iters, kappa_hist, c_hist, pred_hist,
                         crt_hist, generator):
        """One round's SKL bookkeeping and the inefficiency termination
        rule (reference optimization.py:868-913). Appends to the caller's
        history lists in place; returns ``(fit, terminated, relative_skl,
        relative_iters)``."""
        skl = float(approx.kl(avg_prev, avg_curr) + approx.kl(avg_curr, avg_prev))
        skl_hist.append(skl)
        fit, kappa, c = self.weighted_linear_regression(
            np.log(np.asarray(skl_hist)), np.log(np.asarray(lr_hist)),
            generator=generator)
        kappa_hist.append(kappa)
        c_hist.append(c)
        terminated = False
        relative_skl = relative_iters = None
        if len(lr_hist) > 1 and conv_iters:
            lrs = np.asarray(lr_hist, dtype=float)
            convs = np.asarray(conv_iters, dtype=float)
            relative_skl = (self._rho**kappa + self._accuracy_threshold
                            / (np.sqrt(c) * lrs[-1] ** kappa))
            curr_iters = convs[-1]
            _, slope = self.wls(np.log(lrs[-len(convs):]), np.log(convs))
            if self.convg_iteration_trend_detection(slope):
                y_wls, x_wls = convs, lrs[-len(convs):]
            else:
                y_wls, x_wls = convs[1:], lrs[-len(convs):][1:]
            if len(y_wls) >= 2:
                b0, b1 = self.wls(np.log(x_wls), np.log(y_wls))
                pred_iters = int(np.exp(b0) * (self._rho * lrs[-1]) ** b1)
                pred_hist.append(pred_iters)
                relative_iters = pred_iters / (curr_iters + self._iters0)
                crt_hist.append(relative_skl * relative_iters)
                terminated = (relative_skl * relative_iters
                              > self._inefficiency_threshold)
        return fit, terminated, relative_skl, relative_iters

    # outer-loop scalar histories carried through whole-run resume; the
    # *_NONE lists may hold None entries (encoded as -1), the *_INT lists
    # restore as Python ints, the rest as floats
    _RESUME_HISTS_NONE = ("k_Rhat", "k_conv", "k_mcse")
    _RESUME_HISTS_INT = ("conv_iters_hist", "predicted_iters_hist",
                         "k_stopped_final_hist")
    _RESUME_HISTS_FLOAT = ("learning_rate_hist", "SKL_history", "kappa_hist",
                           "c_hist", "stopping_crt")
    _RESUME_HISTS = _RESUME_HISTS_NONE + _RESUME_HISTS_INT + _RESUME_HISTS_FLOAT

    def _one_round(self, K_max, objective, init_param, generator,
                   progress_callback, resume_state, max_time):
        """RAABBVI over a family with no closed-form KL: the rounds have
        nothing to compare, so the run is one FASO round at the
        constructor's rate, as in the reference. Its result is FASO's, with
        what RAABBVI keeps a round in RAABBVI's form: ``k_conv`` and
        ``k_Rhat`` are one-round lists, and ``resume_state`` holds the
        round's FASO state under ``"flight"`` while the round can go on
        (``None`` once FASO has stopped), which a later call resumes."""
        flight = None if resume_state is None else resume_state["flight"]
        res = super().optimize(K_max, objective, init_param, generator=generator,
                               resume_state=flight, progress_callback=progress_callback,
                               max_time=max_time)
        return {**res, "k_conv": [res["k_conv"]], "k_Rhat": [res["k_Rhat"]],
                "resume_state": (None if res["k_stopped"] is not None
                                 else {"flight": res["resume_state"]})}

    def optimize(self, K_max, objective, init_param, generator=None,
                 progress_callback=None, resume_state=None, max_time=None):
        """Run RAABBVI. ``progress_callback(k, avg_loss)`` fires at every
        inner-FASO segment boundary with ``k`` counted across rounds.

        The weighted regression's HMC draws from its own generator on the
        run's device (``init_param``'s), seeded from ``generator``'s
        initial seed; on a card each regression is one kernel launch.

        ``max_time`` (seconds; default the constructor's) budgets the whole
        run: each round gets what is left, and a run that runs out stops
        between rounds or, through FASO's budget, inside one, with
        ``timed_out`` set and a ``resume_state`` that continues it.
        ``resume_state``: the ``results["resume_state"]`` of an earlier run
        that ran out of iterations (``K_max``) or time; the outer loop
        resumes (round counter, decayed learning rate and threshold,
        histories, step-rule state, both generators) and, when the run
        stopped inside a round, that round through its own FASO state
        under ``"flight"``. With the same or a larger ``K_max`` the resumed
        run reproduces the uninterrupted one (set ``max_history``, so the
        ring sizes agree). ``results["resume_state"]`` is ``None`` once the
        termination rule fired.
        """
        max_time = self._max_time if max_time is None else float(max_time)
        if generator is None:
            generator = default_generator(init_param.device)
        if not objective.approx.supports_kl:
            print("WARNING: approximation family does not support KL. "
                  "Using FASO.", flush=True)
            return self._one_round(K_max, objective, init_param, generator,
                                   progress_callback, resume_state, max_time)
        hmc_generator = torch.Generator(init_param.device).manual_seed(
            generator.initial_seed())
        # the whole-run clock is read only under a budget, so the stubbed
        # clocks of the tests keep their schedules
        run_start = _now() if max_time is not None else None

        def time_left():
            return (None if max_time is None
                    else max(max_time - (_now() - run_start), 0.0))

        K_max = int(K_max)
        k_new = -1        # iterations used at the current learning rate
        k = 0             # number of learning-rate decays
        k_total = 0       # total iterations across rounds
        k_add = 0
        budget_spent = 0  # iterations of the finished rounds (+1 each)
        k_stopped_final = None
        sgo = self._sgo
        diagnostics = sgo._diagnostics
        averaged = self._averaged_sgo()
        # explicit per-round state: rounds carry their own lr / threshold,
        # so repeated optimize() calls on one RAABBVI behave identically
        lr_round = sgo._learning_rate
        mcse_round = self._mcse_threshold
        iterate_average_curr = init_param.detach().clone()
        opt_state = None
        steps_run_total = 0
        history = defaultdict(list)
        history["iterate_average_curr_hist"].append(iterate_average_curr)
        history["k_mcse"].append(0)
        stopped = False
        budget_spent_on_resume = False
        timed_out = False
        relative_skl = relative_iters = None
        flight = None          # the stopped round's FASO state, on resume
        resume_payload = None  # what results["resume_state"] carries
        # cumulative (iteration, new_S) escalation events across rounds: the
        # climbed num_mc_samples persists on the shared objective
        mc_events_outer = []

        if resume_state is not None:
            rs = resume_state
            k = int(rs["k"])
            k_total = int(rs["k_total"])
            k_add = int(rs["k_add"])
            budget_spent = int(rs["budget_spent"])
            steps_run_total = int(rs["steps_run_total"])
            lr_round = float(rs["lr_round"])
            mcse_round = float(rs["mcse_round"])
            iterate_average_curr = torch.as_tensor(
                rs["iterate_average_curr"]).to(iterate_average_curr)
            opt_state = _clone_state(rs["opt_state"]) if rs["opt_state"] else None
            _set_generator_state(generator, rs["generator_state"])
            _set_generator_state(hmc_generator, rs["hmc_generator_state"])
            history = defaultdict(list)
            history["iterate_average_curr_hist"] = list(
                torch.as_tensor(rs["iterate_average_curr_hist"]).to(iterate_average_curr))
            for name in self._RESUME_HISTS:
                vals = np.asarray(rs["hists"][name])
                if name in self._RESUME_HISTS_NONE:
                    history[name] = [None if int(v) < 0 else int(v) for v in vals]
                elif name in self._RESUME_HISTS_INT:
                    history[name] = [int(v) for v in vals]
                else:
                    history[name] = [float(v) for v in vals]
            flight = rs["flight"] if isinstance(rs["flight"], dict) else None
            if self._mc_escalation is not None:
                # a resume between rounds re-arms the escalated sample count
                # (inside a round, the flight's FASO state carries it)
                mc_events_outer = _restore_rounds_ladder(rs, objective)
            # the budget left for the stopped (or next) round: what an
            # uninterrupted run with this K_max would have given it
            K_max -= budget_spent
            if K_max <= 0:
                print("WARNING: resume budget already spent; increase K_max")
                # fall through to the standard results, so the restored
                # histories come back under the usual keys; the run stays
                # resumable with a larger K_max
                budget_spent_on_resume = True
                resume_payload = resume_state

        def outer_snapshot():
            """The outer state as of the start of the current round."""
            hists = {}
            for name in self._RESUME_HISTS:
                vals = history[name]
                if name in self._RESUME_HISTS_NONE:
                    hists[name] = np.asarray([-1 if v is None else int(v) for v in vals],
                                             dtype=np.int64)
                elif name in self._RESUME_HISTS_INT:
                    hists[name] = np.asarray(vals, dtype=np.int64)
                else:
                    hists[name] = np.asarray(vals, dtype=float)
            return {
                "k": k, "k_total": k_total, "k_add": k_add,
                "budget_spent": budget_spent,
                "steps_run_total": steps_run_total,
                "lr_round": lr_round, "mcse_round": mcse_round,
                "iterate_average_curr": iterate_average_curr,
                "opt_state": opt_state if opt_state is not None else {},
                "generator_state": generator.get_state(),
                "hmc_generator_state": hmc_generator.get_state(),
                "iterate_average_curr_hist": torch.stack(
                    history["iterate_average_curr_hist"]),
                "hists": hists,
                **_rounds_ladder_state(objective, self._mc_escalation, mc_events_outer),
            }

        while not stopped and not budget_spent_on_resume:
            if flight is None:
                budget_spent += k_new + 1
                K_max -= (k_new + 1)
                out_of_time = (max_time is not None
                               and _agreed(objective, time_left()) <= 0)
                if K_max <= 0 or out_of_time:
                    # the iteration or wall-clock budget ran out between
                    # rounds: resumable at the next round
                    timed_out = out_of_time and K_max > 0
                    resume_payload = {**outer_snapshot(), "flight": ()}
                    break
            round_snapshot = outer_snapshot()
            iterate_average_prev = iterate_average_curr
            # a resumed round already ran this many steps before it stopped;
            # its FASO counts k from the round start but returns only the
            # steps after the resume
            flight_presteps = int(flight["k"]) if flight is not None else 0
            round_steps_offset = steps_run_total
            round_cb = None
            if progress_callback is not None:
                round_cb = (lambda kk, loss, _off=steps_run_total:
                            progress_callback(_off + kk, loss))
            # one budget on every rank of a sharded objective
            round_max_time = (None if max_time is None
                              else _agreed(objective, time_left()))
            if k == 0 and self._init_rmsprop:
                # the warm-start round with plain RMSProp (reference 815-818)
                faso = FASO(RMSProp(learning_rate=lr_round, diagnostics=diagnostics),
                            max_history=self._max_history)
                with span("viabel.raabbvi.round"):
                    opt = faso.optimize(K_max, objective, iterate_average_curr,
                                        generator=generator, resume_state=flight,
                                        progress_callback=round_cb,
                                        max_time=round_max_time)
            else:
                with span("viabel.raabbvi.round"):
                    opt = super().optimize(K_max, objective, iterate_average_curr,
                                           generator=generator, init_opt_state=opt_state,
                                           learning_rate=lr_round,
                                           mcse_threshold=mcse_round,
                                           resume_state=flight,
                                           progress_callback=round_cb,
                                           max_time=round_max_time)
                if not averaged:
                    # persist non-averaged SGO state across rounds (the
                    # reference only resets averaged SGOs, 865-866)
                    opt_state = opt["opt_state"]
            timed_out = opt["timed_out"]
            flight = None
            if "value_history" in opt:
                steps_run_total += flight_presteps + int(opt["value_history"].shape[0])
            if opt["k_stopped"] is not None and k != 0:
                history["conv_iters_hist"].append(opt["k_stopped"])
            iterate_average_curr = opt["opt_param"]
            history["iterate_average_curr_hist"].append(iterate_average_curr)
            history["rhat_verdicts"].append(opt["rhat_verdicts"])
            k_new = opt["k_stopped"]
            if len(opt.get("mc_escalation_history", ())):
                # round-local event iterations on the cumulative axis
                mc_events_outer.extend(
                    (int(ev_k) + round_steps_offset, int(ev_S))
                    for ev_k, ev_S in opt["mc_escalation_history"])

            history["k_Rhat"].append(
                opt["k_Rhat"] + k_add
                if opt["k_Rhat"] is not None and k_new is not None
                else opt["k_Rhat"])
            history["k_conv"].append(
                opt["k_conv"] + k_add
                if opt["k_conv"] is not None and k_new is not None
                else opt["k_conv"])
            history["k_mcse"].append(k_new + k_add if k_new is not None else k_new)
            if "value_history" in opt:
                history["value_history"].append(opt["value_history"])
            if diagnostics:
                if "grad_history" in opt:
                    history["grad_history"].append(opt["grad_history"])
                    history["descent_dir_history"].append(opt["descent_dir_history"])
                if opt["k_conv"] is not None and "ess_history" in opt:
                    history["ess_history"].extend(opt["ess_history"])
                    history["mcse_history"].extend(opt["mcse_history"])
                    history["final_mcse_history"].append(opt["mcse_history"][-1])
                if "iterate_average_k_history" in opt:
                    offsets = np.asarray(opt["iterate_average_k_history"])
                    averages = list(opt["iterate_average_history"])
                    if k > 0:
                        offsets = offsets[1:] + k_add
                        averages = averages[1:]
                    history["iterate_average_history"].extend(averages)
                    history["iterate_average_k_history"].extend(offsets.tolist())
            if history["iterate_average_k_history"]:
                k_add = history["iterate_average_k_history"][-1]

            if k_new is None:  # the iteration or time budget ran out mid-round
                # resumable: the outer state as of this round's start, plus
                # the round's own FASO state
                resume_payload = {**round_snapshot, "flight": opt["resume_state"]}
                break

            # learning-rate decay and threshold tightening (reference 862-866)
            k_total += k_new
            lr_round *= self._rho
            mcse_round *= self._rho

            if len(history["learning_rate_hist"]) > 0:
                fit, terminated, relative_skl, relative_iters = \
                    self.skl_round_update(
                        objective.approx, iterate_average_prev,
                        iterate_average_curr,
                        skl_hist=history["SKL_history"],
                        lr_hist=history["learning_rate_hist"],
                        conv_iters=history["conv_iters_hist"],
                        kappa_hist=history["kappa_hist"],
                        c_hist=history["c_hist"],
                        pred_hist=history["predicted_iters_hist"],
                        crt_hist=history["stopping_crt"],
                        generator=hmc_generator)
                if diagnostics:
                    history["c_sample_hist"].append(
                        np.exp(fit["log_c"].cpu().numpy()))
                    if averaged:
                        history["kappa_sample_hist"] = None
                    else:
                        history["kappa_sample_hist"].append(
                            fit["kappa"].cpu().numpy())
                if terminated:
                    stopped = True
                    k_stopped_final = k_total
                    history["k_stopped_final_hist"].append(k_total)
                    break

            history["learning_rate_hist"].append(lr_round)
            k += 1

        if stopped:
            print("Termination rule reached at iteration", k_total)
            print("Inefficiency Index:", relative_skl * relative_iters)
        elif not budget_spent_on_resume and not timed_out:
            print("WARNING: maximum number of iterations reached before "
                  "stopping rule was triggered")

        results = {}
        for name, h in history.items():
            if name in ("k_Rhat", "k_mcse", "k_conv"):
                continue
            if name == "value_history" and h:
                results[name] = torch.cat(h)
            elif name in ("grad_history", "descent_dir_history") and h:
                results[name] = np.concatenate(h)
            elif name in ("iterate_average_curr_hist", "iterate_average_history"):
                results[name] = torch.stack(h)
            elif h is not None:
                # scalar histories become arrays; ragged ones stay lists
                if isinstance(h, list) and h and np.isscalar(h[0]):
                    results[name] = np.asarray(h)
                else:
                    results[name] = h
        results["opt_param"] = iterate_average_curr
        results["k_stopped_final"] = k_stopped_final
        results["timed_out"] = timed_out
        if self._mc_escalation is not None:
            results["mc_escalation_history"] = _events_array(mc_events_outer)
        results["k_Rhat"] = history["k_Rhat"]
        results["k_mcse"] = history["k_mcse"]
        results["k_conv"] = history["k_conv"]
        # None once the termination rule fired (nothing left to resume)
        results["resume_state"] = resume_payload
        return results
