"""Traffic of kind ``diagnostics``: the front door, ``vi_diagnostics``, on
the q a user fitted, one call after another for the window.

Set-up checks the fit's first steps, fits q by ``fit_iters`` steps of the
configuration's ``bbvi`` call on the run's generator, and makes one call
that warms the window's shapes. Call ``i`` of the window draws from a
fresh generator seeded from the run's seed and ``i``, and ends in a
synchronisation (its answers are read on the host). Parameters (traffic
file): ``fit_iters``, ``n_samples``, ``checked_calls`` of the window's
first ``checked_from`` calls, drawn from the seed, are checked.

The check goes stage by stage. The log weights that a checked call made
(kept by a wrapper around ``convenience.samples_and_log_weights``) are
held against the reference's, worked out in float64 from the same base
normals; khat, the branch, d2 and the bounds against the reference's
PSIS and bounds in float64 on those same log weights. End to end, khat
is not a number that float32 can hold to the reference: an order swap
at the tail's cutoff moves it by up to about 1e-3. The reference starts
from the q that set-up fitted, which is the call's input: the stage that
made q is checked by its first steps.
"""

import math
import random
import time
from contextlib import contextmanager

import numpy as np
import torch

from .. import compare, reference
from ..program import data_seed, generator_seed
from ..reference import diagnostics as ref_diag
from . import steps

_BOUNDS = ("W1", "W2", "mean_error", "std_error", "cov_error")
_ROW_BLOCK = 20_000


def _call_generator(run, i):
    return torch.Generator(run.system.device).manual_seed(generator_seed(run.seed, 2 + i))


def _answers(res):
    out = {"khat": float(res["khat"]), "branch": "bounds" if "d2" in res else "ksd"}
    if out["branch"] == "bounds":
        out.update({k: float(res[k]) for k in ("d2",) + _BOUNDS})
    return out


def _call(run, i):
    system = run.system
    run.window["current"] = i
    res = system.vt.vi_diagnostics(run.check["q"], model=system.model, approx=system.approx,
                                   n_samples=int(run.traffic["n_samples"]),
                                   generator=_call_generator(run, i))
    return _answers(res)


def checked_calls(run):
    """The calls the reference recomputes, drawn from the seed."""
    return sorted(random.Random(run.seed).sample(range(int(run.traffic["checked_from"])),
                                                 int(run.traffic["checked_calls"])))


@contextmanager
def _keep_log_weights(run):
    """Keep, on the host, the log weights that each checked call makes."""
    from viabel_torch import convenience
    fn, kept, checked = convenience.samples_and_log_weights, run.check["log_weights"], set(
        checked_calls(run))

    def wrapped(*args, **kwargs):
        samples, log_weights = fn(*args, **kwargs)
        if run.window.get("current") in checked:
            kept[run.window["current"]] = log_weights.detach().cpu()
        return samples, log_weights

    convenience.samples_and_log_weights = wrapped
    try:
        yield
    finally:
        convenience.samples_and_log_weights = fn


def setup(run):
    steps.drive(run)
    res = run.system.fit(run.generator, n_iters=int(run.traffic["fit_iters"]))
    run.check["q"] = res["opt_param"].detach().clone()
    run.check["log_weights"] = {}
    del res
    warm = _call(run, -1)
    run.log(f"set-up fit: khat {warm['khat']!r}, branch {warm['branch']}")


def window(run, seconds):
    done = run.window
    calls = done["calls"] = []
    with _keep_log_weights(run):
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            calls.append(_call(run, len(calls)))
        run.sync()
        done["seconds"] = time.perf_counter() - start
    done["attempted"] = len(calls)
    done["failed"] = sum(1 for c in calls if not math.isfinite(c["khat"]))
    khats = [c["khat"] for c in calls]
    done["summary"] = (f"khat {min(khats)!r}..{max(khats)!r} over {len(calls)} calls, "
                       f"branch {'/'.join(sorted({c['branch'] for c in calls}))}")


def reference_log_weights(run, i, dtype):
    """Call ``i``'s log weights worked out again in ``dtype`` from its
    base normals, as a float64 array."""
    system = run.system
    n, d = int(run.traffic["n_samples"]), system.dim
    log_p = reference.model(run.config, data_seed(run.seed), dtype, system.device)
    family = reference.family(run.config, d)
    q = run.check["q"].to(dtype)
    z = torch.randn((n, d), generator=_call_generator(run, i), dtype=system.dtype,
                    device=system.device)
    blocks = []
    with torch.no_grad():
        for r in range(0, n, _ROW_BLOCK):
            x = family.draws(q, z[r:r + _ROW_BLOCK].to(dtype))
            blocks.append((log_p(x) - family.log_q(q, x)).double().cpu())
    return torch.cat(blocks).numpy()


def _moments(run, dtype):
    family = reference.family(run.config, run.system.dim)
    with torch.no_grad():
        return family.moments(run.check["q"].to(dtype))


def stage_numbers(side, ref):
    """Gaps of one call's answers against the reference's on the same
    log weights."""
    out = {"khat_gap": abs(side["khat"] - ref["khat"]),
           "branch_mismatch": float(side["branch"] != ref["branch"]
                                    and abs(ref["khat"] - ref_diag.KHAT_GATE) > 0.01)}
    if side["branch"] == ref["branch"] == "bounds":
        out["d2_gap"] = compare.rel_gap(side["d2"], ref["d2"], floor=1e-12)
        out["bounds_gap"] = max(compare.rel_gap(side[k], ref[k], floor=1e-12) for k in _BOUNDS)
    elif side["branch"] == ref["branch"]:
        # both on the KSD branch: neither side has bounds to differ
        out["d2_gap"] = out["bounds_gap"] = 0.0
    return out


def _worst(rows):
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def verify(run):
    nums, run.ref = steps.verify(run)
    moments = _moments(run, torch.float64)
    rows = []
    for i in checked_calls(run):
        if i >= len(run.window["calls"]):
            run.log(f"call {i} is due for the check and the window did not reach it")
            rows.append({"log_weights_gap": math.inf})
            continue
        side, lw = run.window["calls"][i], run.check["log_weights"][i].double().numpy()
        ref = ref_diag.answers(lw, moments)
        row = stage_numbers(side, ref)
        ref_lw = reference_log_weights(run, i, torch.float64)
        row["log_weights_gap"] = (float(np.max(np.abs(lw - ref_lw)))
                                  if lw.shape == ref_lw.shape else math.inf)
        run.log(f"call {i}: program {side}, reference {ref}, "
                f"log weights within {row['log_weights_gap']!r}")
        rows.append(row)
    nums.update(_worst(rows))
    return nums


def control(run):
    """The control, stage by stage: the log weights worked out in float32
    with TF32 matrix products; PSIS and the bounds (no matrix product)
    on those log weights, centred at their largest and rounded to
    bfloat16; each held against float64."""
    nums = steps.control(run, run.ref)
    saved = torch.backends.cuda.matmul.allow_tf32
    rows = []
    for i in checked_calls(run):
        ref_lw = reference_log_weights(run, i, torch.float64)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            low_lw = reference_log_weights(run, i, run.system.dtype)
            low_moments = _moments(run, run.system.dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        centred = torch.as_tensor(low_lw - low_lw.max()).to(torch.bfloat16).double().numpy()
        row = stage_numbers(ref_diag.answers(centred, low_moments),
                            ref_diag.answers(low_lw, _moments(run, torch.float64)))
        row["log_weights_gap"] = float(np.max(np.abs(low_lw - ref_lw)))
        rows.append(row)
    nums.update(_worst(rows))
    return nums
