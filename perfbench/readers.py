"""What the metric readers in ``metrics/`` share: the traced window's
kernels by name, and the shapes a configuration runs at.

A reader is ``read(ctx) -> number or None``; ``ctx`` holds the run's
``window`` (what the kind counted), ``setup_s``, the ``trace`` (a
:class:`perfbench.trace.Trace`, or None when the run was not traced),
the ``spans``, the ``launches`` counted by the program, the
``config``, the ``traffic`` and the ``system``. A reader that finds
nothing to read returns None and the metric is left out of the line.
"""

import re

from .reference.fit import detection_group

RING_KERNEL = re.compile(r"\bgroup_stats_(vec|scalar)\b")
STL_KERNEL = re.compile(r"\bstl_solve<")
TRI_KERNEL = re.compile(r"\btri_solve<")


def kernel_time(ctx, pattern):
    """``(device seconds, launches)`` of the traced window's kernels whose
    name matches ``pattern``; None without a trace or a launch."""
    tr = ctx["trace"]
    if tr is None:
        return None
    totals = tr.kernel_totals(pattern)
    count = sum(c for _, c in totals.values())
    if count == 0:
        return None
    return sum(s for s, _ in totals.values()), count


def idle_share(ctx):
    """Per cent of the traced window in which no operation ran on the
    card."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)


def shapes(ctx):
    """``(family, d, n_data, var_param_dim, dtype name)`` of the run."""
    cfg = ctx["config"]
    d, family = int(cfg["model"]["dim"]), cfg["family"]["class"]
    n_params = d + d * d if family == "FullRankGaussian" else 2 * d
    return family, d, int(cfg["model"]["n_data"]), n_params, cfg["dtype"]


def ring_rows(ctx):
    """The rows of FASO's ring in the window's fits: ``max_history`` (or
    ``n_iters``), at least ``2 W_min``, rounded up to whole groups."""
    bbvi = ctx["system"].bbvi_kw
    raabbvi = bbvi.get("RAABBVI_kwargs", {})
    W_min, k_check = int(raabbvi.get("W_min", 200)), int(raabbvi.get("k_check", 200))
    group = detection_group(W_min, k_check)
    rows = max(int(raabbvi.get("max_history") or bbvi["n_iters"]), 2 * W_min)
    return -(-rows // group) * group, group


def step_bounds(ctx, per_step):
    """Sum over the window's steps of ``per_step(S)``, S the sample count
    of each step."""
    return sum(n * per_step(S) for S, n in ctx["window"]["steps_by_samples"].items())


def roofline_share(bound_s, device_s):
    return 100.0 * bound_s / device_s
