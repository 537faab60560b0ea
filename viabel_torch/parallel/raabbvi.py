"""Batched RAABBVI: B adaptive learning-rate-decay optimizations at once
(counterpart of ``viabel_tpu/parallel/raabbvi.py``, its lockstep
schedule).

``multistart_raabbvi`` runs B independent RAABBVI machines: rounds of
fixed-learning-rate FASO at geometrically decaying per-restart learning
rates, the symmetrized KL between each restart's successive round
averages, the Bayesian weighted ``log SKL ~ log lr`` regression, and the
per-restart inefficiency termination rule (reference
``viabel/optimization.py:812-917``, applied to every restart on its own).
Rounds advance in lockstep: each is one :func:`multistart_faso` call
carrying every restart's own learning rate and MCSE threshold; a restart
that stops early freezes its round average and keeps stepping until the
slowest live restart's round ends, and a restart that has terminated or
spent its budget rides along at ``learning_rate = 0``. Every decision
uses only the restart's own quantities.

Restart ``b`` draws from one generator through all its rounds, and its
regression's HMC from a generator on the restart's device seeded from
that generator's initial seed, exactly as a single ``RAABBVI`` run does
(on a card, one ``wlr_hmc`` kernel launch a regression); at ``B = 1`` the restart's generator is the
caller's, so the run is the port's ``RAABBVI.optimize`` on it.

``schedule="async"`` removes the round barrier: every restart advances
through one sequence of ``k_check``-step segments, and a restart whose
MCSE stop fires does its round bookkeeping at that segment boundary and
starts its next round at once, while the others' rounds go on
(:func:`_multistart_raabbvi_async`).

With ``mesh=`` the restarts split over the mesh's restart axis as in
:func:`multistart_faso`: each rank steps its own restarts and runs their
round regressions (their HMC), the regressions' outcomes and the
per-restart statistics are all-gathered, and every rank keeps the whole
outer bookkeeping, so the step count, the budget and the end agree.
"""

from collections import deque

import numpy as np
import torch

from ..detection import (_candidate_windows, _CheckCadence, _detection_geometry,
                         _events_array, _events_of, _host_handle, _MCLadder, _read_host,
                         _recheck_scale, _restore_rounds_ladder, _rounds_ladder_state,
                         _to_host_async)
from ..faso import RAABBVI
from ..optimizers import RMSProp, StochasticGradientOptimizer
from ..utils import Timer, _clone_state, _now, _set_generator_state
from .mesh import restart_axis_of
from .multistart import (_BatchedEngine, _gather_owned, _resume_rings, _ring_span,
                         _RunState, multistart_faso, restart_generators)

__all__ = ["multistart_raabbvi"]


def multistart_raabbvi(sgo, K_max, objective, init_params, generator=None, *,
                       rho=0.5, iters0=1000, accuracy_threshold=0.1,
                       inefficiency_threshold=1.0, init_rmsprop=False,
                       learning_rate=None, mcse_threshold=0.1, W_min=200,
                       ESS_min=None, k_check=None, max_history=None,
                       rhat_threshold=1.1, rhat_quantile=None, rhat_backoff=None,
                       rhat_group=None, check_pipeline=4, mesh=None,
                       restart_axis="restart", resume_state=None, round_callback=None,
                       schedule="lockstep", verbose=True, max_time=None,
                       mc_escalation=None, mc_max_samples=None, mc_patience=3,
                       mc_plateau_rtol=0.05):
    """Run ``B = init_params.shape[0]`` RAABBVI optimizations in lockstep
    rounds.

    Parameters mirror :class:`~viabel_torch.RAABBVI` (``rho``, ``iters0``,
    ``accuracy_threshold``, ``inefficiency_threshold``) plus
    :func:`multistart_faso`'s detection knobs. ``learning_rate`` /
    ``mcse_threshold`` may be scalars or shape-``(B,)`` arrays for
    per-restart starting grids; each restart decays its own by ``rho``.

    ``init_rmsprop`` runs the first round with a plain :class:`RMSProp`
    rule at each restart's starting rate and default detection settings,
    like single-run RAABBVI's warm start (reference
    optimization.py:815-818); ``sgo`` takes over from round two.

    ``objective.approx`` must support closed-form KL. ``round_callback(
    n_rounds, resume_state)`` fires after every completed round with a
    snapshot (save it with :mod:`viabel_torch.checkpoint`); passing it
    back as ``resume_state`` with the same ``K_max``, kwargs and
    ``generator`` device type continues at the next round and reproduces
    the uninterrupted run. ``results["resume_state"]`` carries the last
    snapshot.

    ``mc_escalation`` and its knobs: the shared ladder of
    :func:`multistart_faso`, inherited through the rounds like single-run
    RAABBVI: the climbed ``num_mc_samples`` persists on the objective, the
    ceiling is pinned to ``40 * S`` at run entry, and the events land in
    ``results["mc_escalation_history"]`` on the ``k_global_steps`` axis.

    ``max_time`` (seconds) budgets the whole run: expiry stops at a round
    boundary (the round in flight gets what is left and stops inside it),
    with ``timed_out`` set and a round-boundary snapshot. ``schedule``:
    ``"lockstep"``, or ``"async"`` (per-restart round clocks, see
    :func:`_multistart_raabbvi_async`; its snapshots are taken at segment
    boundaries and resume mid-round, and its results add
    ``n_rounds_per_restart`` and ``obj_state_errors``). ``mesh`` /
    ``restart_axis``: the restarts split over that axis of a
    ``DeviceMesh`` on both schedules (see the module docstring); every
    rank calls with the same arguments and gets the same results.

    Returns a dict with ``opt_param`` (B, D) final round averages,
    per-restart lists ``k_stopped_final`` (None where the termination rule
    never fired), ``budget_overrun`` (steps a restart's returned average
    absorbed past its own budget, because its round was sized for a
    longer-budget sibling), ``k_total``, ``conv_iters_hist``,
    ``learning_rate_hist``, ``SKL_history``, ``kappa_hist``, ``c_hist``,
    ``predicted_iters_hist``, ``stopping_crt``, ``n_rounds``,
    ``k_global_steps`` (lockstep steps run), ``timed_out`` and
    ``resume_state``.
    """
    if not isinstance(sgo, StochasticGradientOptimizer):
        raise ValueError("sgo must be a subclass of StochasticGradientOptimizer")
    if not objective.approx.supports_kl:
        raise ValueError("multistart_raabbvi needs a family with closed-form "
                         "KL (approx.supports_kl); use multistart_faso")
    if schedule not in ("lockstep", "async"):
        raise ValueError('"schedule" must be "lockstep" or "async"')
    if mc_escalation is not None:
        # pin the ceiling to the run's entry sample count: each round would
        # otherwise re-derive 40 * (current S). Both schedules raise here for
        # an objective with no sample count, also with an explicit
        # mc_max_samples (where the JAX package's async leg meets an
        # AttributeError)
        mc_max_samples = _MCLadder.pinned_ceiling(objective, mc_max_samples)
    init_params = torch.as_tensor(init_params).detach()
    B, D = init_params.shape
    K_max = int(K_max)
    restarts = None if mesh is None else restart_axis_of(mesh, restart_axis, B)
    split = dict(mesh=mesh, restart_axis=restart_axis)
    if schedule == "async":
        generators = restart_generators(generator, B, init_params.device)
        hmc_generators = [torch.Generator(g.device).manual_seed(g.initial_seed())
                          for g in generators]
        escalation = dict(mc_escalation=mc_escalation, mc_max_samples=mc_max_samples,
                          mc_patience=mc_patience, mc_plateau_rtol=mc_plateau_rtol)
        prelude_state = None
        async_resume, async_max_time = resume_state, max_time
        if init_rmsprop and (resume_state is None or "prelude_flight" in resume_state):
            # the warm round as a lockstep prelude; its wall clock counts
            # against the run's budget
            t0 = _now() if max_time is not None else None
            out = _async_warm_prelude(
                sgo, K_max, objective, init_params, generators, hmc_generators,
                rho=rho, learning_rate=learning_rate, mcse_threshold=mcse_threshold,
                max_history=K_max if max_history is None else int(max_history),
                max_time=max_time, resume_state=resume_state, split=split,
                restarts=restarts, **escalation)
            if out.get("timed_out"):
                return out
            prelude_state, async_resume = out, None
            if max_time is not None:
                async_max_time = max(float(max_time) - (_now() - t0), 0.0)
        return _multistart_raabbvi_async(
            sgo, K_max, objective, init_params, generators, hmc_generators,
            rho=rho, iters0=iters0, accuracy_threshold=accuracy_threshold,
            inefficiency_threshold=inefficiency_threshold, learning_rate=learning_rate,
            mcse_threshold=mcse_threshold, W_min=W_min, ESS_min=ESS_min, k_check=k_check,
            max_history=max_history, rhat_threshold=rhat_threshold,
            rhat_quantile=rhat_quantile, rhat_backoff=rhat_backoff, rhat_group=rhat_group,
            check_pipeline=check_pipeline, resume_state=async_resume,
            prelude_state=prelude_state, round_callback=round_callback, verbose=verbose,
            max_time=async_max_time, restarts=restarts, **escalation)
    run_start = _now() if max_time is not None else None

    def agree(x):
        return x if restarts is None else restarts.agree(x)

    def _time_left():
        return (None if max_time is None
                else max(float(max_time) - agree(_now() - run_start), 0.0))

    if max_history is None:
        # pin the ring size across rounds
        max_history = K_max

    # the single-run machinery: regression posterior and HMC, closed-form
    # WLS, trend detection, the averaged-rule kappa shortcut
    helper = RAABBVI(sgo, rho=rho, iters0=iters0, accuracy_threshold=accuracy_threshold,
                     inefficiency_threshold=inefficiency_threshold)
    averaged = helper._averaged_sgo()

    lr = np.broadcast_to(np.asarray(sgo._learning_rate if learning_rate is None
                                    else learning_rate, dtype=float), (B,)).copy()
    mcse = np.broadcast_to(np.asarray(mcse_threshold, dtype=float), (B,)).copy()
    # a resumed run sets each generator's saved state below
    generators = restart_generators(generator, B, init_params.device)
    hmc_generators = [torch.Generator(g.device).manual_seed(g.initial_seed())
                      for g in generators]

    mc_events_outer = []
    # per-restart outer state (the reference's loop variables, one copy a
    # restart)
    K_rem = np.full(B, K_max)
    k_new = np.full(B, -1)          # last round's iterations (-1 before any)
    k_dec = np.zeros(B, dtype=int)  # learning-rate decays so far
    k_total = np.zeros(B, dtype=int)
    active = np.ones(B, dtype=bool)
    k_stopped_final = [None] * B
    budget_overrun = np.zeros(B, dtype=int)
    avg_curr = init_params
    opt_states = None  # persisted across rounds for non-averaged rules
    conv_iters = [[] for _ in range(B)]
    lr_hist = [[] for _ in range(B)]
    skl_hist = [[] for _ in range(B)]
    kappa_hist = [[] for _ in range(B)]
    c_hist = [[] for _ in range(B)]
    pred_hist = [[] for _ in range(B)]
    crt_hist = [[] for _ in range(B)]
    n_rounds = 0
    k_global_steps = 0

    if resume_state is not None:
        rs = resume_state
        K_rem = np.asarray(rs["K_rem"]).copy()
        k_new = np.asarray(rs["k_new"]).copy()
        k_dec = np.asarray(rs["k_dec"]).copy()
        k_total = np.asarray(rs["k_total"]).copy()
        active = np.asarray(rs["active"]).copy()
        k_stopped_final = [None if int(v) < 0 else int(v)
                           for v in np.asarray(rs["k_stopped_final"])]
        avg_curr = torch.as_tensor(rs["avg_curr"]).to(init_params)
        opt_states = list(rs["opt_states"]) or None
        lr = np.asarray(rs["lr"], dtype=float).copy()
        mcse = np.asarray(rs["mcse"], dtype=float).copy()
        for g, state in zip(generators, rs["generator_states"]):
            _set_generator_state(g, state)
        for g, state in zip(hmc_generators, rs["hmc_generator_states"]):
            _set_generator_state(g, state)
        n_rounds = int(rs["n_rounds"])
        k_global_steps = int(rs["k_global_steps"])
        conv_iters = [[int(v) for v in h] for h in rs["conv_iters_hist"]]
        lr_hist = [[float(v) for v in h] for h in rs["learning_rate_hist"]]
        skl_hist = [[float(v) for v in h] for h in rs["SKL_history"]]
        kappa_hist = [[float(v) for v in h] for h in rs["kappa_hist"]]
        c_hist = [[float(v) for v in h] for h in rs["c_hist"]]
        pred_hist = [[int(v) for v in h] for h in rs["predicted_iters_hist"]]
        crt_hist = [[float(v) for v in h] for h in rs["stopping_crt"]]
        budget_overrun = np.asarray(rs["budget_overrun"]).copy()
        if mc_escalation is not None:
            # re-arm the escalated sample count and the event log
            mc_events_outer = _restore_rounds_ladder(rs, objective)

    def outer_snapshot():
        """Round-boundary state (ragged per-restart histories are lists of
        Python-scalar lists, which viabel_torch.checkpoint serializes)."""
        return {
            "K_rem": K_rem.copy(), "k_new": k_new.copy(),
            "k_dec": k_dec.copy(), "k_total": k_total.copy(),
            "active": active.copy(),
            "k_stopped_final": np.asarray([-1 if v is None else v
                                           for v in k_stopped_final]),
            "budget_overrun": budget_overrun.copy(),
            "avg_curr": avg_curr,
            "opt_states": list(opt_states) if opt_states is not None else [],
            "lr": lr.copy(), "mcse": mcse.copy(),
            "generator_states": torch.stack(_gather_owned(
                restarts, [g.get_state() for g in generators])),
            "hmc_generator_states": torch.stack(_gather_owned(
                restarts, [g.get_state() for g in hmc_generators])),
            "n_rounds": n_rounds,
            "k_global_steps": k_global_steps,
            "conv_iters_hist": [list(h) for h in conv_iters],
            "learning_rate_hist": [list(h) for h in lr_hist],
            "SKL_history": [list(h) for h in skl_hist],
            "kappa_hist": [list(h) for h in kappa_hist],
            "c_hist": [list(h) for h in c_hist],
            "predicted_iters_hist": [list(h) for h in pred_hist],
            "stopping_crt": [list(h) for h in crt_hist],
            **_rounds_ladder_state(objective, mc_escalation, mc_events_outer),
        }

    detection_kwargs = dict(
        W_min=W_min, ESS_min=ESS_min, k_check=k_check, max_history=max_history,
        rhat_threshold=rhat_threshold, rhat_quantile=rhat_quantile,
        rhat_backoff=rhat_backoff, rhat_group=rhat_group,
        check_pipeline=check_pipeline, diagnostics=False,
        mc_escalation=mc_escalation, mc_max_samples=mc_max_samples,
        mc_patience=mc_patience, mc_plateau_rtol=mc_plateau_rtol)
    # the warm round mirrors single-run RAABBVI's: a plain RMSProp rule and
    # a default-constructed FASO (only max_history carried)
    warm_sgo = RMSProp(float(lr.mean())) if init_rmsprop else None

    # snapshots are valid only at round boundaries (the loop-top budget
    # accounting runs once a round on resume)
    snapshot = outer_snapshot()
    timed_out = False
    while True:
        # the wall-clock budget, before the once-a-round budget accounting
        if max_time is not None and _time_left() <= 0:
            timed_out = True
            if verbose:
                print("WARNING: wall-clock budget ({:g} s) reached at a round "
                      "boundary; returning partial results "
                      "(resumable)".format(float(max_time)))
            break
        # per-restart budget accounting (reference: K_max -= k_new + 1)
        for b in np.flatnonzero(active):
            K_rem[b] -= k_new[b] + 1
            if K_rem[b] <= 0:
                active[b] = False
        living = np.flatnonzero(active)
        if living.size == 0:
            break
        n_iters_round = int(K_rem[living].max())
        # dead restarts ride along at lr = 0: constant iterates pass the
        # detection gates at once and never block the early exit
        lr_round = np.where(active, lr, 0.0)
        warm_round = init_rmsprop and n_rounds == 0
        if warm_round:
            opt = multistart_faso(warm_sgo, n_iters_round, objective, avg_curr,
                                  generators=generators, learning_rate=lr_round,
                                  max_time=_time_left(), max_history=max_history,
                                  diagnostics=False, **split)
        else:
            opt = multistart_faso(sgo, n_iters_round, objective, avg_curr,
                                  generators=generators, learning_rate=lr_round,
                                  mcse_threshold=mcse, init_opt_states=opt_states,
                                  max_time=_time_left(), **split, **detection_kwargs)
        if opt["timed_out"]:
            # recovery is round-granular: the interrupted round is rolled
            # back (the loop-top accounting is re-applied on resume)
            timed_out = True
            break
        n_rounds += 1
        round_len = int(opt["value_history"].shape[1])
        # round-local events on the cumulative lockstep-step axis
        mc_events_outer.extend((int(ev_k) + k_global_steps, int(ev_S))
                               for ev_k, ev_S in opt.get("mc_escalation_history", ()))
        k_global_steps += round_len
        if not averaged and not warm_round:
            # persist non-averaged step-rule state across rounds, each
            # stopped restart's as of its own stop
            opt_states = opt["opt_states_at_stop"]

        def round_stop(b):
            """Restart b's stop in this round, None past its own budget."""
            k_stopped_b = opt["k_stopped"][b]
            return None if k_stopped_b is not None and k_stopped_b > K_rem[b] else k_stopped_b

        # the regressions first, each on the rank that owns its restart
        todo = {}
        for b in living:
            k_stopped_b = round_stop(b)
            if k_stopped_b is not None and lr_hist[b]:
                conv = conv_iters[b] + ([int(k_stopped_b)] if k_dec[b] != 0 else [])
                todo[b] = (avg_curr[b], opt["opt_param"][b], conv)
        terminated_by = _round_regressions(
            helper, objective.approx, todo, hmc_generators, restarts,
            skl_hist=skl_hist, lr_hist=lr_hist, kappa_hist=kappa_hist, c_hist=c_hist,
            pred_hist=pred_hist, crt_hist=crt_hist)
        new_avgs = avg_curr.clone()
        for b in living:
            k_stopped_b = opt["k_stopped"][b]
            if k_stopped_b is not None and k_stopped_b > K_rem[b]:
                # converged only past this restart's own budget: a single
                # run would have hit max-iterations; the adopted average
                # absorbed the extra steps
                budget_overrun[b] = int(k_stopped_b - K_rem[b])
                k_stopped_b = None
            elif k_stopped_b is None and round_len > K_rem[b]:
                budget_overrun[b] = int(round_len - K_rem[b])
            new_avgs[b] = opt["opt_param"][b]
            if k_stopped_b is not None and k_dec[b] != 0:
                conv_iters[b].append(int(k_stopped_b))
            k_new[b] = -1 if k_stopped_b is None else int(k_stopped_b)
            if k_stopped_b is None:  # the restart's budget ran out
                active[b] = False
                continue
            # learning-rate decay and threshold tightening (reference 862-866)
            k_total[b] += int(k_stopped_b)
            lr_next = lr[b] * rho
            mcse[b] *= rho
            if lr_hist[b]:
                if terminated_by[b]:
                    active[b] = False
                    k_stopped_final[b] = int(k_total[b])
                    if verbose:
                        print(f"restart {b}: termination rule reached at iteration "
                              f"{k_total[b]} (inefficiency index {crt_hist[b][-1]:.3g})")
                    continue
            lr_hist[b].append(lr_next)
            lr[b] = lr_next
            k_dec[b] += 1
        avg_curr = new_avgs
        # the round's B rings go before the next round allocates its own
        del opt
        snapshot = outer_snapshot()
        if round_callback is not None:
            round_callback(n_rounds, snapshot)

    if verbose and not timed_out:
        unfinished = [b for b in range(B) if k_stopped_final[b] is None]
        if unfinished:
            print("WARNING: restarts", unfinished, "reached the iteration budget "
                  "before their stopping rule was triggered")

    results = {
        "opt_param": avg_curr,
        "k_stopped_final": k_stopped_final,
        "timed_out": timed_out,
        "budget_overrun": [int(v) for v in budget_overrun],
        "k_total": [int(v) for v in k_total],
        "conv_iters_hist": conv_iters,
        "learning_rate_hist": lr_hist,
        "SKL_history": skl_hist,
        "kappa_hist": kappa_hist,
        "c_hist": c_hist,
        "predicted_iters_hist": pred_hist,
        "stopping_crt": crt_hist,
        "n_rounds": n_rounds,
        "k_global_steps": k_global_steps,
        "resume_state": snapshot,
    }
    if mc_escalation is not None:
        results["mc_escalation_history"] = _events_array(mc_events_outer)
    return results


def _round_regressions(helper, approx, todo, hmc_generators, restarts, **hists):
    """RAABBVI's round regression (``skl_round_update``: the SKL between
    round averages, the weighted regression and its HMC, the termination
    rule) of each restart in ``todo`` (``{b: (avg_prev, avg_curr,
    conv_iters)}``), run by the rank that owns ``b`` on the ``restarts``
    axis (every one without a split). Returns ``{b: terminated}`` on every
    rank and brings b's appended history lists (``hists``: the keyword
    lists of ``skl_round_update``) up to date on every rank."""
    grown = ("skl_hist", "kappa_hist", "c_hist", "pred_hist", "crt_hist")
    owned = range(len(hmc_generators)) if restarts is None else restarts.rows(
        len(hmc_generators))
    mine = {}
    for b in sorted(todo):
        if b not in owned:
            continue
        avg_prev, avg_curr, conv = todo[b]
        _fit, terminated, _rskl, _rit = helper.skl_round_update(
            approx, avg_prev, avg_curr, conv_iters=conv, generator=hmc_generators[b],
            **{name: h[b] for name, h in hists.items()})
        mine[b] = (bool(terminated), [list(hists[name][b]) for name in grown])
    if restarts is None:
        return {b: out[0] for b, out in mine.items()}
    terminated_by = {}
    if todo:
        for part in restarts.gather_objects(mine):
            for b, (terminated, lists) in part.items():
                for name, values in zip(grown, lists):
                    hists[name][b][:] = values
                terminated_by[b] = terminated
    return terminated_by


def _empty_hists(B):
    return [[] for _ in range(B)]


def _async_warm_prelude(sgo, K_max, objective, init_params, generators, hmc_generators, *,
                        rho, learning_rate, mcse_threshold, max_history, max_time,
                        resume_state=None, split=None, restarts=None, mc_escalation=None,
                        mc_max_samples=None, mc_patience=3, mc_plateau_rtol=0.05):
    """Round one of an async ``init_rmsprop`` run (the JAX package's
    raabbvi.py:569-713): one lockstep :func:`multistart_faso` round on a
    plain ``RMSProp`` at each restart's starting rate with the default
    detection settings (single-run RAABBVI's warm start), then each
    restart's round-one bookkeeping. Every restart starts round one at
    the same step anyway, so only the stragglers of this one round idle.

    Returns the state that seeds :func:`_multistart_raabbvi_async` at
    each restart's round two, or, when the wall-clock budget runs out
    inside the warm round, a full timed-out results dict whose
    ``resume_state`` carries the round's own state under
    ``prelude_flight``; passing it back re-enters the warm round there.
    """
    B, D = init_params.shape
    lr = np.broadcast_to(np.asarray(sgo._learning_rate if learning_rate is None
                                    else learning_rate, dtype=float), (B,)).copy()
    mcse = np.broadcast_to(np.asarray(mcse_threshold, dtype=float), (B,)).copy()
    flight = None
    if resume_state is not None:
        flight = resume_state["prelude_flight"]
        for g, state in zip(hmc_generators, resume_state["hmc_generator_states"]):
            _set_generator_state(g, state)
    opt = multistart_faso(RMSProp(float(lr.mean())), K_max, objective, init_params,
                          generators=generators, learning_rate=lr, max_history=max_history,
                          diagnostics=False, resume_state=flight, max_time=max_time,
                          **(split or {}),
                          mc_escalation=mc_escalation, mc_max_samples=mc_max_samples,
                          mc_patience=mc_patience, mc_plateau_rtol=mc_plateau_rtol)
    # the warm round starts the global step axis, so its ladder events
    # carry over unshifted; the climbed S persists on the objective
    mc_events = _events_of(opt.get("mc_escalation_history", np.zeros((0, 2))))
    # the warm round's steps, those before a resume included (the JAX
    # package counts only the steps after it)
    round_len = int(opt["value_history"].shape[1]) + (0 if flight is None
                                                      else int(flight["k"]))
    if opt["timed_out"]:
        out = {
            "timed_out": True,
            "opt_param": opt["opt_param"],
            "k_stopped_final": [None] * B,
            "budget_overrun": [0] * B,
            "k_total": [0] * B,
            "n_rounds": 0,
            "n_rounds_per_restart": [0] * B,
            "k_global_steps": round_len,
            "obj_state_errors": opt.get("obj_state_errors", [None] * B),
            "resume_state": {
                "prelude_flight": opt["resume_state"],
                "hmc_generator_states": torch.stack(_gather_owned(
                    restarts, [g.get_state() for g in hmc_generators])),
            },
        }
        for name in ("conv_iters_hist", "learning_rate_hist", "SKL_history", "kappa_hist",
                     "c_hist", "predicted_iters_hist", "stopping_crt"):
            out[name] = _empty_hists(B)
        if mc_escalation is not None:
            out["mc_escalation_history"] = _events_array(mc_events)
        return out

    # per-restart round-one bookkeeping (single-run RAABBVI's first round:
    # budget, decay, threshold tightening; no regression yet)
    K_rem = np.full(B, int(K_max))
    active = np.ones(B, dtype=bool)
    final_avg = [None] * B
    avg_prev = [None] * B
    lr_hist = _empty_hists(B)
    n_rounds_b = np.zeros(B, dtype=int)
    k_dec = np.zeros(B, dtype=int)
    k_total = np.zeros(B, dtype=int)
    for b in range(B):
        ks = opt["k_stopped"][b]
        avg_b = opt["opt_param"][b]
        if ks is None:
            # the budget ran out inside the warm round
            active[b] = False
            lr[b] = 0.0
            final_avg[b] = avg_b
            continue
        K_rem[b] -= int(ks) + 1
        k_total[b] = int(ks)
        n_rounds_b[b] = 1
        mcse[b] *= rho
        avg_prev[b] = avg_b
        # the lr entry comes unconditionally, as the lockstep schedule books
        # it before retiring an exhausted restart at its next loop top
        lr_hist[b].append(lr[b] * rho)
        lr[b] *= rho
        k_dec[b] = 1
        if K_rem[b] <= 0:
            active[b] = False
            lr[b] = 0.0
            final_avg[b] = avg_b
    return {"lr": lr, "mcse": mcse, "K_rem": K_rem, "k_total": k_total, "k_dec": k_dec,
            "active": active, "final_avg": final_avg, "avg_prev": avg_prev,
            "lr_hist": lr_hist, "n_rounds_b": n_rounds_b,
            "var_params": opt["opt_param"], "k_global_offset": round_len,
            "mc_events": mc_events}


def _multistart_raabbvi_async(sgo, K_max, objective, init_params, generators,
                              hmc_generators, *, rho, iters0, accuracy_threshold,
                              inefficiency_threshold, learning_rate, mcse_threshold, W_min,
                              ESS_min, k_check, max_history, rhat_threshold, rhat_quantile,
                              rhat_backoff, rhat_group, check_pipeline, resume_state=None,
                              prelude_state=None, round_callback=None, verbose=True,
                              max_time=None, restarts=None, mc_escalation=None,
                              mc_max_samples=None, mc_patience=3, mc_plateau_rtol=0.05):
    """Per-restart round clocks in one continuous program (the JAX
    package's raabbvi.py:716-1532).

    All B restarts step through one sequence of ``k_check``-step segments
    (:meth:`_BatchedEngine.run_segment`, B single-restart steps a step).
    When restart ``b``'s MCSE stop fires at a segment boundary, the host
    does its round advance at once: the symmetrized KL against its
    previous round average, the weighted regression, the termination
    rule, the learning-rate and threshold decay, and a restart from the
    round average with a fresh averaged-rule state. The other restarts'
    rounds go on. Terminated or exhausted restarts ride along at
    ``learning_rate = 0``, so the generators advance as in the JAX
    package.

    Carried over from the JAX package:

    - windows are round-local: restart ``b``'s candidates are capped at
      ``k - round_start[b]``, so no row of its previous round is read;
    - one R-hat dispatch a segment over the union of every eligible
      restart's ``linspace(W_min, 0.95 k_b, 5)`` windows, padded to a
      power-of-two length; each restart argmins over its own subset;
    - in-flight verdicts carry each restart's round counter, and one
      dispatched before ``b``'s round advanced is skipped for ``b``;
    - the ``rhat_backoff`` cadence is shared and resets when any restart
      starts a round; budgets are enforced at segment boundaries, and
      ``budget_overrun`` records the steps past them;
    - the escalation ladder is shared (one S), climbing only when every
      live restart's binding gate has plateaued; the plateau trackers are
      per restart and cleared at its round advance.

    Departure: restart ``b``'s ring clock restarts at each of its rounds
    (:class:`_RunState`'s ``origins``), so a round's ring statistics are
    those of a fresh FASO round to the bit and ``B = 1`` is the port's
    ``RAABBVI.optimize`` bit for bit. The JAX package keeps one clock for
    every ring; its older rows then enter the cumulative group sums
    (never a window), which moves its statistics by round-off.

    ``round_callback(total_rounds, snapshot)`` fires after every segment
    in which a restart advanced or retired; the snapshot (rings copied,
    in-flight verdicts read to the host) resumes mid-round through
    ``resume_state``. Stateful objectives need
    ``objective.reset_obj_state_rows``; a degenerate state is recorded
    per restart in ``obj_state_errors``.
    """
    B, D = init_params.shape
    device, dtype = init_params.device, init_params.dtype
    K_max = int(K_max)
    if max_history is None:
        max_history = K_max  # pin the ring size, as the lockstep leg does
    helper = RAABBVI(sgo, rho=rho, iters0=iters0, accuracy_threshold=accuracy_threshold,
                     inefficiency_threshold=inefficiency_threshold)
    averaged = helper._averaged_sgo()
    if not getattr(objective, "scannable", True):
        raise ValueError("multistart_raabbvi requires a scannable objective")
    k_check, ESS_min, G, R, rhat_allowed = _detection_geometry(
        D, W_min, k_check, ESS_min, rhat_group, rhat_quantile, rhat_backoff,
        int(max_history))
    gate = rhat_threshold if rhat_allowed is None else rhat_allowed
    engine = _BatchedEngine(sgo, objective, init_params, G=G, diagnostics=False,
                            rhat_allowed=rhat_allowed, rhat_threshold=rhat_threshold,
                            restarts=restarts)
    local = engine.local
    if engine.stateful and not hasattr(objective, "reset_obj_state_rows"):
        raise ValueError(
            'schedule="async" with a stateful objective requires a per-restart '
            "round reset (objective.reset_obj_state_rows); use the lockstep schedule")

    lr = np.broadcast_to(np.asarray(sgo._learning_rate if learning_rate is None
                                    else learning_rate, dtype=float), (B,)).copy()
    mcse = np.broadcast_to(np.asarray(mcse_threshold, dtype=float), (B,)).copy()
    K_rem = np.full(B, K_max)
    k_total = np.zeros(B, dtype=int)
    k_dec = np.zeros(B, dtype=int)
    active = np.ones(B, dtype=bool)
    k_stopped_final = [None] * B
    budget_overrun = np.zeros(B, dtype=int)
    n_rounds_b = np.zeros(B, dtype=int)
    round_id = np.zeros(B, dtype=int)
    round_start = np.zeros(B, dtype=int)   # global k at b's round start
    avg_prev = [None] * B                  # previous round average (D,)
    final_avg = [None] * B                 # retired restarts' results (D,)
    conv_iters, lr_hist, skl_hist = _empty_hists(B), _empty_hists(B), _empty_hists(B)
    kappa_hist, c_hist, pred_hist, crt_hist = (_empty_hists(B), _empty_hists(B),
                                               _empty_hists(B), _empty_hists(B))

    # one S for the batch; the trackers are round-local
    ladder = _MCLadder(objective, B, mc_escalation, mc_max_samples, mc_patience,
                       mc_plateau_rtol)

    k_offset = 0  # the warm prelude's steps, counted into k_global_steps
    if prelude_state is not None:
        ps = prelude_state
        lr, mcse = ps["lr"].copy(), ps["mcse"].copy()
        K_rem, k_total, k_dec = ps["K_rem"].copy(), ps["k_total"].copy(), ps["k_dec"].copy()
        active = ps["active"].copy()
        n_rounds_b = ps["n_rounds_b"].copy()
        avg_prev, final_avg = list(ps["avg_prev"]), list(ps["final_avg"])
        lr_hist = [list(h) for h in ps["lr_hist"]]
        init_params = ps["var_params"]
        k_offset = int(ps["k_global_offset"])
        ladder.events = list(ps["mc_events"])

    obj_errors = [None] * B
    k = 0
    if resume_state is None:
        var_params = list(init_params.clone())
        opt_states = [sgo.init_state(vp) for vp in var_params]
        obj_states = engine.init_obj_states(var_params)
        if engine.stateful:
            # a hook that cannot reset rows raises here, not at the first
            # round advance (on a fresh state the call changes nothing)
            obj_states = objective.reset_obj_state_rows(obj_states, range(B))
        rings = [torch.zeros((R, D), dtype=dtype, device=device) if b in local else None
                 for b in range(B)]
        t = 0
    # else: everything comes from resume_state below (fresh rings first
    # would hold two sets at once)

    k_conv = np.full(B, -1)       # per restart, in round-local iterations
    k_stopped = np.full(B, -1)
    W_check = np.full(B, -1)
    last_best_W = np.full(B, -1)
    frozen = [None] * B           # round average at a restart's MCSE stop
    last_checked_avg = [None] * B
    pending = deque()
    cadence = _CheckCadence(rhat_backoff, rhat_threshold, rhat_allowed, max(1, R // k_check))
    mcse_time_total = 0.0
    loop_start = _now()

    if resume_state is not None:
        rs = resume_state
        var_params = [torch.as_tensor(v).to(init_params).clone() for v in rs["var_params"]]
        opt_states = [_clone_state(st) for st in rs["opt_states"]]
        obj_states = [_clone_state(st) for st in rs["obj_states"]]
        # the messages do not go through the checkpoint; the flags do
        obj_errors = ["objective state flagged invalid before the checkpoint"
                      if bool(f) else None for f in np.asarray(rs["obj_error_flags"])]
        for g, state in zip(generators, rs["generator_states"]):
            _set_generator_state(g, state)
        for g, state in zip(hmc_generators, rs["hmc_generator_states"]):
            _set_generator_state(g, state)
        # copies: segments write the rings in place
        rings = _resume_rings(rs, local, B, init_params)
        t, k, k_offset = int(rs["t"]), int(rs["k"]), int(rs["k_offset"])
        lr = np.asarray(rs["lr"], dtype=float).copy()
        mcse = np.asarray(rs["mcse"], dtype=float).copy()
        K_rem = np.asarray(rs["K_rem"]).copy()
        k_total = np.asarray(rs["k_total"]).copy()
        k_dec = np.asarray(rs["k_dec"]).copy()
        active = np.asarray(rs["active"]).astype(bool).copy()
        k_stopped_final = [None if int(v) < 0 else int(v)
                           for v in np.asarray(rs["k_stopped_final"])]
        budget_overrun = np.asarray(rs["budget_overrun"]).copy()
        n_rounds_b = np.asarray(rs["n_rounds_b"]).copy()
        round_id = np.asarray(rs["round_id"]).copy()
        round_start = np.asarray(rs["round_start"]).copy()

        def rows(name):
            return [None if r is None else torch.as_tensor(r).to(init_params)
                    for r in rs[name]]

        avg_prev, final_avg = rows("avg_prev"), rows("final_avg")
        frozen, last_checked_avg = rows("frozen"), rows("last_checked_avg")
        k_conv = np.asarray(rs["k_conv"]).copy()
        k_stopped = np.asarray(rs["k_stopped"]).copy()
        W_check = np.asarray(rs["W_check"]).copy()
        last_best_W = np.asarray(rs["last_best_W"]).copy()
        cadence.restore(rs)
        mcse_time_total = float(rs["mcse_time_total"])
        # the elapsed optimization time carries over, so the recheck cost
        # model stays continuous
        loop_start = _now() - float(rs["opt_elapsed"])
        pending.extend({"k": int(ck["k"]), "windows": np.asarray(ck["windows"]),
                        "masks": np.asarray(ck["masks"]).astype(bool),
                        "round_id": np.asarray(ck["round_id"]),
                        "r_hats": _host_handle(ck["r_hats"])}
                       for ck in rs["pending_checks"])
        conv_iters = [[int(v) for v in h] for h in rs["conv_iters_hist"]]
        lr_hist = [[float(v) for v in h] for h in rs["learning_rate_hist"]]
        skl_hist = [[float(v) for v in h] for h in rs["SKL_history"]]
        kappa_hist = [[float(v) for v in h] for h in rs["kappa_hist"]]
        c_hist = [[float(v) for v in h] for h in rs["c_hist"]]
        pred_hist = [[int(v) for v in h] for h in rs["predicted_iters_hist"]]
        crt_hist = [[float(v) for v in h] for h in rs["stopping_crt"]]
        ladder.restore(rs)
    # lr is shared with the run state: round advances and retirements
    # write it in place
    run = _RunState(var_params, opt_states, obj_states, generators, rings, lr, t,
                    origins=round_start)

    # the events held plus every climb still possible from the current S,
    # sized after the prelude and resume restores
    ladder.size_log(held=len(ladder.events))

    def outer_snapshot(copy_rings):
        """The continuous program at a segment boundary. Mid-run the rings
        are copied (the next segment writes them in place) and in-flight
        verdicts are read to the host."""
        return {
            "var_params": engine.gather_rows(torch.stack([run.var_params[b]
                                                          for b in local])),
            "opt_states": engine.gather_list([_clone_state(st) for st in run.opt_states],
                                             device),
            "obj_states": engine.gather_list([_clone_state(st) for st in run.obj_states],
                                             device),
            "obj_error_flags": np.asarray([e is not None
                                           for e in engine.gather_list(obj_errors)]),
            "generator_states": torch.stack(engine.gather_list(
                [g.get_state() for g in generators])),
            "hmc_generator_states": torch.stack(engine.gather_list(
                [g.get_state() for g in hmc_generators])),
            "rings": [run.rings[b].clone() if copy_rings else run.rings[b] for b in local],
            **_ring_span(restarts, local, B),
            "t": run.t, "k": k, "k_offset": k_offset,
            "lr": lr.copy(), "mcse": mcse.copy(),
            "K_rem": K_rem.copy(), "k_total": k_total.copy(),
            "k_dec": k_dec.copy(), "active": active.copy(),
            "k_stopped_final": np.asarray([-1 if v is None else v for v in k_stopped_final]),
            "budget_overrun": budget_overrun.copy(),
            "n_rounds_b": n_rounds_b.copy(),
            "round_id": round_id.copy(),
            "round_start": round_start.copy(),
            # None-or-(D,) rows: the .npz checkpoint keeps a None as no leaf
            "avg_prev": list(avg_prev), "final_avg": list(final_avg),
            "frozen": list(frozen), "last_checked_avg": list(last_checked_avg),
            "k_conv": k_conv.copy(), "k_stopped": k_stopped.copy(),
            "W_check": W_check.copy(), "last_best_W": last_best_W.copy(),
            **cadence.state(),
            "mcse_time_total": mcse_time_total,
            "opt_elapsed": engine.agree(_now() - loop_start),
            "pending_checks": [{"k": int(ck["k"]), "windows": ck["windows"],
                                "masks": ck["masks"], "round_id": ck["round_id"],
                                "r_hats": _read_host(ck["r_hats"])} for ck in pending],
            "conv_iters_hist": [list(h) for h in conv_iters],
            "learning_rate_hist": [list(h) for h in lr_hist],
            "SKL_history": [list(h) for h in skl_hist],
            "kappa_hist": [list(h) for h in kappa_hist],
            "c_hist": [list(h) for h in c_hist],
            "predicted_iters_hist": [list(h) for h in pred_hist],
            "stopping_crt": [list(h) for h in crt_hist],
            **ladder.state(),
        }

    def ring_clock(b):
        return int(k - round_start[b])

    def process_check(ck):
        r_hats = _read_host(ck["r_hats"])          # (B, K)
        windows = ck["windows"]                    # the padded union
        best_stats = []
        for b in range(B):
            if not active[b] or k_conv[b] >= 0:
                continue
            if ck["round_id"][b] != round_id[b]:
                continue  # stale: b's round advanced since the dispatch
            mask = ck["masks"][b]
            if not mask.any():
                continue
            r = np.where(mask, r_hats[b], np.inf)
            best = int(np.argmin(r))
            last_best_W[b] = int(windows[best])
            best_stats.append(r[best])
            if r[best] <= gate:
                k_conv[b] = int(ck["k"]) - round_start[b] - int(windows[best])
                W_check[b] = int(windows[best])
            else:
                ladder.track_rhat(b, int(ck["k"]), r[best])
        if best_stats:
            cadence.adjust(min(best_stats), int(ck["k"]), k)

    def settle(b, avg):
        """Retire restart ``b`` with ``avg`` as its result."""
        active[b] = False
        lr[b] = 0.0
        if avg is not None:
            final_avg[b] = avg

    def drain_for_restart(b):
        """Restart ``b``'s in-flight verdicts, applied before it retires at
        its budget (FASO's final drain: a pass keeps the window extended
        over the steps run while the verdict was in flight)."""
        for ck in pending:
            if k_conv[b] >= 0:
                break
            if ck["round_id"][b] != round_id[b]:
                continue
            mask = ck["masks"][b]
            if not mask.any():
                continue
            r = np.where(mask, _read_host(ck["r_hats"])[b], np.inf)
            best = int(np.argmin(r))
            best_W = int(ck["windows"][best])
            last_best_W[b] = best_W
            if r[best] <= gate:
                k_conv[b] = int(ck["k"]) - round_start[b] - best_W
                W_check[b] = best_W
                w_eff = min(best_W + (k - int(ck["k"])), R, ring_clock(b))
                last_checked_avg[b] = engine.mean_of(b, run.rings, ring_clock(b), w_eff)

    def fallback_estimate(b):
        """Restart ``b``'s best estimate when its round ends without an
        MCSE stop (budget or wall clock): FASO's max-iterations chain for
        one restart. Returns a (D,) row, or None."""
        drain_for_restart(b)
        if last_checked_avg[b] is not None:
            return last_checked_avg[b]
        kb = ring_clock(b)
        if (k_conv[b] >= 0 or last_best_W[b] > 0) and kb > 0:
            W_f = max(kb - k_conv[b], 1) if k_conv[b] >= 0 else max(int(last_best_W[b]), 1)
            return engine.mean_of(b, run.rings, kb, min(W_f, R, kb))
        return avg_prev[b]

    def advance_restart(b, terminated_by):
        """Restart ``b``'s MCSE stop fired: its round bookkeeping (the
        reference's optimization.py:812-917 for this restart alone), with
        its regression's outcome in ``terminated_by``. Returns its next
        round's start, or None if it retired."""
        k_new_b = int(k_stopped[b])
        avg_b = frozen[b]
        if k_new_b > K_rem[b]:
            # stopped only past its own budget (at most one segment late):
            # a single run would have hit max-iterations
            budget_overrun[b] = int(k_new_b - K_rem[b])
            settle(b, avg_b)
            return None
        K_rem[b] -= k_new_b + 1
        if k_dec[b] != 0:
            conv_iters[b].append(k_new_b)
        k_total[b] += k_new_b
        n_rounds_b[b] += 1
        lr_next = lr[b] * rho
        mcse[b] *= rho
        if lr_hist[b]:
            if terminated_by[b]:
                k_stopped_final[b] = int(k_total[b])
                settle(b, avg_b)
                if verbose:
                    print(f"restart {b}: termination rule reached at iteration "
                          f"{k_total[b]} (inefficiency index {crt_hist[b][-1]:.3g})")
                return None
        if K_rem[b] <= 0:
            # budget spent exactly between rounds
            settle(b, avg_b)
            return None
        lr_hist[b].append(lr_next)
        lr[b] = lr_next
        k_dec[b] += 1
        avg_prev[b] = avg_b
        # b's round clock and detection state start over (its ring clock
        # with them: round_start is the run state's ring origin)
        round_id[b] += 1
        round_start[b] = k
        k_conv[b] = k_stopped[b] = W_check[b] = last_best_W[b] = -1
        frozen[b] = last_checked_avg[b] = None
        ladder.clear(b)
        return avg_b

    def maybe_escalate():
        # one S for the batch: the rung climbs only when every live
        # restart's binding gate (its own round's tracker) has plateaued
        live = [b for b in range(B) if active[b] and k_stopped[b] < 0]
        stats = ladder.stalled(live, k_conv >= 0)
        if stats is None:
            return
        # events on the run's step axis, the warm prelude's steps included
        new_S = ladder.climb(k, at=k + k_offset)
        if engine.stateful:
            run.obj_states = engine.resize_obj_states(run.obj_states, run.var_params)
        # the new noise regime at full cadence; converged restarts recheck
        # one W_min after the climb (round-local)
        cadence.reset(k)
        for b in live:
            if k_conv[b] >= 0:
                W_check[b] = (ring_clock(b) - k_conv[b]) + W_min
        if verbose:
            print("MC escalation: convergence gates stalled (worst {:.3g}); "
                  "num_mc_samples -> {} at iteration {}".format(
                      max(stats), new_S, k + k_offset))

    # the budget is a fresh allotment each call (loop_start carries the
    # recheck cost model across resumes); read only when one is set
    run_start = _now() if max_time is not None else None
    timed_out = False
    while np.any(active):
        if max_time is not None and engine.agree(_now() - run_start) >= float(max_time):
            timed_out = True
            if verbose:
                print("WARNING: wall-clock budget ({:g} s) reached at iteration {}; "
                      "returning partial results (resumable)".format(float(max_time), k))
            break
        engine.run_segment(run, k_check)
        k += k_check
        if engine.stateful:
            engine.check_obj_states(run.obj_states, obj_errors, k)

        # one R-hat dispatch over the union of the eligible restarts'
        # candidate windows
        kb = k - round_start
        eligible = []
        for b in range(B):
            if not active[b] or k_conv[b] >= 0:
                continue
            W_upper_b = min(int(0.95 * kb[b]), R)
            if W_upper_b > W_min and W_upper_b >= 2 * G:
                eligible.append((b, W_upper_b))
        if eligible and cadence.due(k):
            cadence.dispatched(k, k_check)
            cand_sets = {b: _candidate_windows(W_min, w, G) for b, w in eligible}
            union = np.unique(np.concatenate(list(cand_sets.values())))
            K_pad = 1 << int(np.ceil(np.log2(max(len(union), 1))))
            windows = np.concatenate([union, np.full(K_pad - len(union), union[0])])
            masks = np.zeros((B, K_pad), dtype=bool)
            for b, _ in eligible:
                masks[b, :len(union)] = np.isin(union, cand_sets[b])
            # every window of the union on each eligible ring (a window
            # longer than b's round reads garbage that b's mask drops)
            r_hats = engine.rhat_rows(run.rings, {b: int(kb[b]) for b, _ in eligible},
                                      windows)
            pending.append({"k": k, "windows": windows, "masks": masks,
                            "round_id": round_id.copy(), "r_hats": _to_host_async(r_hats)})
        while pending and k - int(pending[0]["k"]) >= check_pipeline * k_check:
            process_check(pending.popleft())
            maybe_escalate()

        # the MCSE stop checks, round-local windows
        kb = k - round_start
        due = [b for b in range(B) if active[b] and k_conv[b] >= 0 and k_stopped[b] < 0
               and kb[b] - k_conv[b] >= W_check[b]]
        if due:
            W = np.minimum(np.maximum(kb - k_conv, 1), np.maximum(np.minimum(R, kb), 1))
            # faso's Timer, so the tests' stubbed MCSE cost holds here too
            specs = {b: (int(kb[b]), int(W[b])) for b in due}
            with Timer() as mcse_timer:
                pairs = engine.mcse_rows(run.rings, specs)
                effs = {b: p[0] for b, p in pairs.items()}
                mcses = {b: p[1] for b, p in pairs.items()}
            mcse_interval = engine.agree(mcse_timer.interval)
            mcse_time_total += mcse_interval
            avgs = engine.mean_rows(run.rings, specs)
            for b in due:
                avg = avgs[b]
                if rhat_allowed is None:
                    mcse_stat = float(np.max(mcses[b]))
                    ess_stat = float(np.min(effs[b]))
                else:
                    q = float(rhat_quantile)
                    mcse_stat = float(np.quantile(mcses[b], q))
                    ess_stat = float(np.quantile(effs[b], 1.0 - q))
                if mcse_stat < mcse[b] and ess_stat > ESS_min:
                    k_stopped[b] = int(kb[b])
                    frozen[b] = avg
                else:
                    last_checked_avg[b] = avg
                    ladder.track_mcse(b, int(W[b]) >= R, mcse_stat, mcse[b], ess_stat,
                                      ESS_min)
                    total_opt = max(engine.agree(_now() - loop_start) - mcse_time_total,
                                    1e-9)
                    W_check[b] = int(_recheck_scale(
                        total_opt / k, mcse_interval / int(W[b])) * W_check[b] + 1)
            maybe_escalate()

        # the round regressions first, each on the rank that owns its
        # restart; then round advances and budget enforcement, restart by
        # restart
        todo = {}
        for b in range(B):
            if (active[b] and k_stopped[b] >= 0 and k_stopped[b] <= K_rem[b]
                    and lr_hist[b]):
                conv = conv_iters[b] + ([int(k_stopped[b])] if k_dec[b] != 0 else [])
                todo[b] = (avg_prev[b], frozen[b], conv)
        terminated_by = _round_regressions(
            helper, objective.approx, todo, hmc_generators, restarts,
            skl_hist=skl_hist, lr_hist=lr_hist, kappa_hist=kappa_hist, c_hist=c_hist,
            pred_hist=pred_hist, crt_hist=crt_hist)
        advanced = []
        settled_any = False
        for b in range(B):
            if not active[b]:
                continue
            if k_stopped[b] >= 0:
                new_init = advance_restart(b, terminated_by)
                if new_init is None:
                    settled_any = True
                else:
                    advanced.append(b)
                    run.var_params[b] = new_init.clone()
                    if averaged:
                        # averaged rules start each round fresh (reference
                        # 865-866); other rules keep their state, as of b's
                        # own stop
                        run.opt_states[b] = sgo.init_state(new_init)
            elif k - round_start[b] >= K_rem[b]:
                # b's round ran its whole remaining budget without a stop
                settled_any = True
                budget_overrun[b] = int(k - round_start[b] - K_rem[b])
                est = fallback_estimate(b)
                settle(b, None)
                final_avg[b] = est if est is not None else init_params[b]
        if advanced:
            if engine.stateful:
                run.obj_states = objective.reset_obj_state_rows(run.obj_states, advanced)
            if rhat_backoff is not None:
                # a fresh round needs full-cadence checks
                cadence.reset(k)
        if round_callback is not None and (advanced or settled_any):
            round_callback(int(n_rounds_b.sum()), outer_snapshot(copy_rings=True))

    if verbose and not timed_out:
        unfinished = [b for b in range(B) if k_stopped_final[b] is None]
        if unfinished:
            print("WARNING: restarts", unfinished, "reached the iteration budget "
                  "before their stopping rule was triggered")
    # the snapshot first: the display pass below drains verdicts
    resume_snap = outer_snapshot(copy_rings=False)
    display = {}
    if timed_out:
        # the best current estimate of each running restart, for display
        # (a resume continues them)
        for b in range(B):
            if active[b] and final_avg[b] is None:
                est = fallback_estimate(b)
                if est is not None:
                    display[b] = est
    opt_param = torch.stack([final_avg[b] if final_avg[b] is not None
                             else display.get(b, init_params[b]) for b in range(B)])
    results = {
        "opt_param": opt_param,
        "k_stopped_final": k_stopped_final,
        "timed_out": timed_out,
        "budget_overrun": [int(v) for v in budget_overrun],
        "k_total": [int(v) for v in k_total],
        "conv_iters_hist": conv_iters,
        "learning_rate_hist": lr_hist,
        "SKL_history": skl_hist,
        "kappa_hist": kappa_hist,
        "c_hist": c_hist,
        "predicted_iters_hist": pred_hist,
        "stopping_crt": crt_hist,
        "n_rounds": int(n_rounds_b.max()) if B else 0,
        "n_rounds_per_restart": [int(v) for v in n_rounds_b],
        "k_global_steps": k + k_offset,
        "obj_state_errors": list(obj_errors),
        "resume_state": resume_snap,
    }
    if ladder.escalation is not None:
        results["mc_escalation_history"] = _events_array(ladder.events)
    return results
