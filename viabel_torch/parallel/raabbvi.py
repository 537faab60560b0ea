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
regression's HMC from a generator on :data:`viabel_torch.faso.HMC_DEVICE`
seeded from that generator's initial seed, exactly as a single
``RAABBVI`` run does; at ``B = 1`` the restart's generator is the
caller's, so the run is the port's ``RAABBVI.optimize`` on it.

The asynchronous schedule (per-restart round clocks) is not ported yet.
"""

import numpy as np
import torch

from ..faso import HMC_DEVICE, RAABBVI, _now, _pad_events, _set_generator_state
from ..optimizers import RMSProp, StochasticGradientOptimizer
from ..utils import not_ported
from .multistart import multistart_faso, restart_generators

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
    ``"lockstep"``; ``"async"`` and ``mesh`` belong to the engines that
    are not ported yet.

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
    if schedule == "async":
        raise not_ported('multistart_raabbvi(schedule="async")', "13b")
    if mesh is not None:
        raise not_ported("multistart_raabbvi(mesh=...)", "13b")
    if mc_escalation is not None and mc_max_samples is None:
        # pin the ceiling to the run's entry sample count: each round's
        # multistart_faso would otherwise re-derive 40 * (current S)
        S0 = getattr(objective, "num_mc_samples", None)
        if S0 is None:
            raise ValueError(
                "mc_escalation needs an objective exposing a settable "
                "num_mc_samples (got {})".format(type(objective).__name__))
        mc_max_samples = 40 * int(S0)
    init_params = torch.as_tensor(init_params).detach()
    B, D = init_params.shape
    K_max = int(K_max)
    run_start = _now() if max_time is not None else None

    def _time_left():
        return (None if max_time is None
                else max(float(max_time) - (_now() - run_start), 0.0))

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
    hmc_generators = [torch.Generator(HMC_DEVICE).manual_seed(g.initial_seed())
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
            rs_S = int(rs["mc_samples"])
            if rs_S > 0:
                objective.num_mc_samples = rs_S
            mc_events_outer = [(int(a), int(b)) for a, b in np.asarray(
                rs["mc_events_outer"]).reshape(-1, 2) if a >= 0]

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
            "generator_states": torch.stack([g.get_state() for g in generators]),
            "hmc_generator_states": torch.stack([g.get_state() for g in hmc_generators]),
            "n_rounds": n_rounds,
            "k_global_steps": k_global_steps,
            "conv_iters_hist": [list(h) for h in conv_iters],
            "learning_rate_hist": [list(h) for h in lr_hist],
            "SKL_history": [list(h) for h in skl_hist],
            "kappa_hist": [list(h) for h in kappa_hist],
            "c_hist": [list(h) for h in c_hist],
            "predicted_iters_hist": [list(h) for h in pred_hist],
            "stopping_crt": [list(h) for h in crt_hist],
            "mc_samples": (int(objective.num_mc_samples)
                           if mc_escalation is not None else -1),
            "mc_events_outer": _pad_events(mc_events_outer,
                                           max(len(mc_events_outer), 1)),
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
                                  diagnostics=False)
        else:
            opt = multistart_faso(sgo, n_iters_round, objective, avg_curr,
                                  generators=generators, learning_rate=lr_round,
                                  mcse_threshold=mcse, init_opt_states=opt_states,
                                  max_time=_time_left(), **detection_kwargs)
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
            avg_prev_b = avg_curr[b]
            avg_curr_b = opt["opt_param"][b]
            new_avgs[b] = avg_curr_b
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
                _fit, terminated, _rskl, _rit = helper.skl_round_update(
                    objective.approx, avg_prev_b, avg_curr_b,
                    skl_hist=skl_hist[b], lr_hist=lr_hist[b],
                    conv_iters=conv_iters[b], kappa_hist=kappa_hist[b],
                    c_hist=c_hist[b], pred_hist=pred_hist[b], crt_hist=crt_hist[b],
                    generator=hmc_generators[b])
                if terminated:
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
        results["mc_escalation_history"] = np.asarray(
            mc_events_outer, dtype=np.int64).reshape(-1, 2)
    return results
