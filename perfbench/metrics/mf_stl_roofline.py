"""The mean-field Gaussian's STL draw and score (the ``mf_stl`` kernels)
against their bound, in per cent: the least bytes of each step's forward
and backward at that step's sample count, over the device time of the
traced window's launches. None unless the kernels ran the same number of
times on every step of the window."""

import re

from perfbench import roofline
from perfbench.readers import kernel_time, roofline_share, step_bounds

MF_STL_KERNEL = re.compile(r"\bmf_stl_\w+<")
_SIZE = {"float32": 4, "float64": 8}


def bound_s(S, d, dtype):
    """One step: the draws ``z`` read and ``x`` written going forward, the
    draws' gradient and ``z`` read going back (4 S d elements); ``mu`` and
    ``log_sigma`` read forward, ``log_sigma`` back, the ``(2 d,)`` gradient
    written (5 d); ``log q`` written and its gradient read (2 S). About one
    operation an element, so bytes bound it."""
    nbytes = (4 * S * d + 5 * d + 2 * S) * _SIZE[dtype]
    return roofline.bound_s(nbytes, 0, dtype)


def read(ctx):
    found, steps = kernel_time(ctx, MF_STL_KERNEL), ctx["window"].get("steps")
    if found is None or not steps or found[1] % steps:
        return None
    d, dtype = int(ctx["system"].dim), ctx["config"]["dtype"]
    return roofline_share(step_bounds(ctx, lambda S: bound_s(S, d, dtype)), found[0])
