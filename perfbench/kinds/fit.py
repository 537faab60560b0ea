"""Traffic of kind ``fit``: ``bbvi`` fits, one after another, for the
window.

Each fit is the configuration's ``bbvi`` call from the family's start on
the run's generator, with ``max_time`` set to what is left of the window,
so that the last fit stops at a segment boundary; a fit that ends early
is followed by the next. The adaptive route runs at its own cadence:
R-hat and MCSE checks, escalations of the sample count, RAABBVI rounds
and their regressions. Parameters (traffic file): ``warm_iters``, the
length of a set-up fit that runs the window's path through its first
R-hat checks; ``checked_steps``, how many of the window's last steps the
reference recomputes.

The check reads the window's last FASO round (the last call of
``FASO.optimize``, which a hook keeps during the window) as the window
left it: what the call started from (iterate, RMSProp's state, learning
rate, sample count, generator state) and what it returned (per-step
losses, escalations, and its resume state: the iterates in FASO's ring,
RMSProp's state, the R-hat checks in flight). The reference recomputes,
in float64 from the program's own iterates and the same base normals,
the last ``checked_steps`` steps of that round (each loss, each step's
change of the parameters, RMSProp's state after the last) and kernel
1's R-hat verdict over the ring as the window left it (the least
statistic over the candidate windows, at the same window). Set-up's first steps
are checked besides (``steps.py``), from the family's start.
"""

import math
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from .. import compare, reference
from ..program import data_seed
from ..reference import fit as ref_fit
from . import steps

#: steps recomputed before the checked ones so that RMSProp's state,
#: which forgets by beta = 0.9 a step, is the program's to 0.9**300 < 2e-14
_NU_SETTLE = 300


def setup(run):
    steps.drive(run)
    run.system.fit(run.generator, n_iters=int(run.traffic["warm_iters"]))


def _samples_per_step(res, S0, n):
    """The sample count of each of a fit's ``n`` steps, from its
    escalation events ``(at, S)``: the steps after ``at`` draw S."""
    out = np.full(n, int(S0), dtype=np.int64)
    for at, new_S in np.asarray(res.get("mc_escalation_history", np.zeros((0, 2)))).reshape(-1, 2):
        out[min(int(at), n):] = int(new_S)
    return out


@contextmanager
def _keep_last_round(run):
    """Keep what the last ``FASO.optimize`` call started from and returned
    (one round's ring alive at a time, as RAABBVI itself holds it)."""
    from viabel_torch import faso
    optimize = faso.FASO.optimize

    def hooked(self, n_iters, objective, init_param, generator=None, init_opt_state=None,
               **kwargs):
        run.check["round"] = None
        entry = {"generator_state": generator.get_state(), "S0": int(objective.num_mc_samples),
                 "start": init_param, "opt_state": init_opt_state,
                 "lr": float(kwargs.get("learning_rate") or self._sgo._learning_rate)}
        res = optimize(self, n_iters, objective, init_param, generator=generator,
                       init_opt_state=init_opt_state, **kwargs)
        run.check["round"] = {**entry, "result": res}
        return res

    faso.FASO.optimize = hooked
    try:
        yield
    finally:
        faso.FASO.optimize = optimize


def window(run, seconds):
    with _keep_last_round(run):
        _window(run, seconds)


def _window(run, seconds):
    system, gen = run.system, run.generator
    done = run.window
    done.update(steps=0, fits=0, failed=0, steps_by_samples=Counter(), converged=[])
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            break
        res = system.fit(gen, max_time=left)
        values = res["value_history"]
        n = int(values.shape[0])
        per_step = _samples_per_step(res, system.num_mc_samples, n)
        done["steps"] += n
        done["fits"] += 1
        done["failed"] += int((~torch.isfinite(values)).sum())
        done["steps_by_samples"].update(Counter(per_step.tolist()))
        done["converged"].append([k for k in res.get("k_conv", []) if k is not None])
        del res, values
    run.sync()
    done["seconds"] = time.perf_counter() - start
    done["attempted"] = done["steps"]
    done["summary"] = (f"{done['fits']} fits, steps by sample count "
                       f"{dict(sorted(done['steps_by_samples'].items()))}, R-hat passed at "
                       f"{done['converged']}")


def _last_round(run):
    """What the check reads of the window's last round: ``None`` where it
    ran no step (the window closed as the round began)."""
    rnd = run.check.get("round")
    if not rnd or int(rnd["result"]["resume_state"]["k"]) < 1:
        return None
    res = rnd["result"]
    opt_state = rnd["opt_state"]
    n = int(res["value_history"].shape[0])
    return {"flight": res["resume_state"], "values": res["value_history"],
            "samples": _samples_per_step(res, rnd["S0"], n),
            "generator_state": rnd["generator_state"], "lr": rnd["lr"], "start": rnd["start"],
            "nu0": opt_state["avg_grad_sq"] if opt_state and opt_state.get("t", 0) else None}


def window_steps(run, dtype, store=None):
    """The reference's readings of the window's last checked steps in
    ``dtype``: each step's loss, the per-leaf norms of each step's change
    (the last ``checked_steps``), RMSProp's state after the last step and
    the last step's gradient. ``store``: the precision the iterates are
    kept in, where the reference stands in the program's place."""
    rnd = _last_round(run)
    if rnd is None:
        return None
    system, flight = run.system, rnd["flight"]
    ring, t, kr = flight["ring"], int(flight["t"]), int(flight["k"])
    R, n = ring.shape[0], len(rnd["samples"])
    checked = min(int(run.traffic["checked_steps"]), kr, R - 1)
    m = min(kr, checked + _NU_SETTLE, R - 1)
    exact = m == kr  # the round's own start: its RMSProp state is known

    def row(j):  # the iterate after step j of the round (0: its start)
        if j == 0:
            return rnd["start"]
        return ring[(t - (kr - j) - 1) % R]

    rms = dict(system.bbvi_kw.get("RMS_kwargs", {}))
    log_p = reference.model(run.config, data_seed(run.seed), dtype, system.device)
    family = reference.family(run.config, system.dim)
    nu = (rnd["nu0"].to(dtype) if exact and rnd["nu0"] is not None
          else None if exact else torch.zeros(ring.shape[1], dtype=dtype, device=system.device))
    leaves = family.leaves()
    out = {"losses": [], "change_norms": [], "leaves": leaves}
    draws = steps.base_draws(system, rnd["generator_state"], rnd["samples"], n - m)
    steps_iter = ref_fit.steps_from(
        family, log_p, (row(j) for j in range(kr - m, kr)), draws,
        stl=system.stl, lr=rnd["lr"], beta=float(rms.get("beta", 0.9)),
        jitter=float(rms.get("jitter", 1e-8)), nu=nu, dtype=dtype, store=store)
    for i, (value, change, g, nu) in enumerate(steps_iter):
        out["losses"].append(value)
        if i >= m - checked:
            out["change_norms"].append(compare.leaf_norms(change, leaves))
    out.update(nu=nu, grad=g, checked=checked)
    return out


def program_steps(run, checked):
    """The program's side of the same readings, from the window's last
    fit."""
    rnd = _last_round(run)
    flight = rnd["flight"]
    ring, t, kr = flight["ring"], int(flight["t"]), int(flight["k"])
    R = ring.shape[0]
    m = len(checked["losses"])
    rows = [rnd["start"] if j == 0 else ring[(t - (kr - j) - 1) % R]
            for j in range(kr - checked["checked"], kr + 1)]
    leaves = checked["leaves"]
    return {"losses": rnd["values"][-m:].double().tolist(),
            "change_norms": [compare.leaf_norms(b.double() - a.double(), leaves)
                             for a, b in zip(rows[:-1], rows[1:])],
            "nu": flight["opt_state"]["avg_grad_sq"]}


def window_rhat(run, dtype=torch.float64, round_to=None):
    """Kernel 1's statistic on the ring as the window left it, and the
    reference's from the same rows: the R-hat check dispatched at the last
    step of the window's last fit where there is one (its verdict was
    still in flight), else the program's R-hat routine run on that ring
    once the window has closed. ``round_to``: the rows rounded to this
    type first (the control)."""
    from viabel_torch import faso

    rnd = _last_round(run)
    if rnd is None:
        return None
    flight = rnd["flight"]
    ring, t, kr = flight["ring"], int(flight["t"]), int(flight["k"])
    raabbvi = run.system.bbvi_kw.get("RAABBVI_kwargs", {})
    W_min = int(raabbvi.get("W_min", 200))
    group = ref_fit.detection_group(W_min, int(raabbvi.get("k_check", W_min)))
    # the routine reads steps [t - w, t) with t on the group grid, as FASO's
    # checks do; a round that stopped off the grid is read up to its last
    # grid step, over windows whose rows the ring still holds
    t_grid = t - t % group
    if t_grid < 2 * group:  # a round cut short by the iteration budget
        return None
    W_upper = min(int(0.95 * t_grid), ring.shape[0] - (t - t_grid), t_grid)
    windows = (ref_fit.candidate_windows(W_min, W_upper, group) if W_upper > W_min
               else np.asarray([2 * group * max(1, W_upper // (2 * group))]))
    at_end = [c for c in flight.get("pending_checks", []) if int(c["k"]) == kr]
    if at_end:
        prog_windows, prog = np.asarray(at_end[0]["windows"]), np.asarray(at_end[0]["r_hats"])
        source = f"the check dispatched at step {kr}"
    else:
        prog_windows = windows
        t = t_grid
        prog = faso.split_rhat_ring_windows(ring, t, windows, group).cpu().numpy()
        source = f"the program's R-hat routine on the ring, up to step {kr - (kr % group)}"
    if len(prog_windows) != len(windows) or np.any(prog_windows != windows):
        return {"prog": prog, "ref": None, "windows": prog_windows, "source": source}
    rows = ring if round_to is None else ring.to(round_to)
    ref = [ref_fit.split_rhat_max(rows, t, int(w), dtype=dtype) for w in windows]
    return {"prog": prog, "ref": ref, "windows": windows, "source": source}


def _gaps(side, ref):
    """The window's step numbers: ``side`` against the float64 ``ref``."""
    leaves = ref["leaves"]
    quiet = compare.quiet_leaves(ref["grad"], leaves)
    return {
        "window_loss_gap": max(compare.rel_gap(p, r)
                               for p, r in zip(side["losses"], ref["losses"])),
        "window_change_gap": max(compare.norms_gap(p, r, skip=quiet)
                                 for p, r in zip(side["change_norms"], ref["change_norms"])),
        "window_nu_gap": compare.leaf_norm_gap(side["nu"], ref["nu"], leaves),
    }


def _verdict_gap(prog, ref):
    """The R-hat verdict's statistic, the least over the candidate windows
    as FASO reads it: its gap where both sides pick the same window."""
    best = int(np.argmin(prog))
    if best != int(np.argmin(ref)):
        return math.inf
    return compare.rel_gap(prog[best], ref[best])


def _rhat_gap(read):
    if read is None or read["ref"] is None:
        return math.inf
    return _verdict_gap(read["prog"], read["ref"])


def verify(run):
    nums, ref = steps.verify(run)
    run.ref = ref
    checked = window_steps(run, torch.float64)
    run.window_ref = checked
    if checked is None:
        run.log("the window's last fit ran no step in its round: nothing to recompute")
        nums.update(window_loss_gap=math.inf, window_change_gap=math.inf,
                    window_nu_gap=math.inf)
    else:
        nums.update(_gaps(program_steps(run, checked), checked))
        run.log(f"recomputed the window's last {len(checked['losses'])} steps "
                f"(changes compared over the last {checked['checked']})")
    rhat = window_rhat(run)
    nums["window_rhat_gap"] = _rhat_gap(rhat)
    if rhat is not None:
        run.log(f"R-hat by window {list(map(int, rhat['windows']))} from {rhat['source']}: "
                f"program {[float(x) for x in rhat['prog']]}, reference {rhat['ref']}")
    return nums


def control(run):
    """The control: the reference in the program's place one precision
    below the configuration's (float32 with TF32 matrix products; the
    R-hat statistic, which has no matrix product, on iterates rounded to
    bfloat16), against the float64 reference."""
    out = steps.control(run, run.ref)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = window_steps(run, run.system.dtype, store=run.system.dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    if low is not None and run.window_ref is not None:
        out.update(_gaps(low, run.window_ref))
    ref = window_rhat(run)
    low_rhat = window_rhat(run, round_to=torch.bfloat16)
    if ref is not None and ref["ref"] is not None and low_rhat["ref"] is not None:
        out["window_rhat_gap"] = _verdict_gap(low_rhat["ref"], ref["ref"])
    return out
