"""Kernel 3 (vmem_solve_triangular, the log weights' whitening) against
its bound, in per cent: one (d, n_samples) lower solve a call on the
error-bounds branch, over the device time of the traced window's
launches. Silent where a call took the KSD branch (other shapes)."""

from perfbench import roofline
from perfbench.readers import TRI_KERNEL, kernel_time, roofline_share, shapes


def read(ctx):
    found = kernel_time(ctx, TRI_KERNEL)
    calls = ctx["window"].get("calls") or []
    if found is None or found[1] != len(calls) or any(c["branch"] != "bounds" for c in calls):
        return None
    _, d, _, _, dtype = shapes(ctx)
    n = int(ctx["traffic"]["n_samples"])
    return roofline_share(found[1] * roofline.tri_solve_bound_s(d, n, dtype), found[0])
