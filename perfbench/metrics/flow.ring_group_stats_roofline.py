"""Kernel 1 (ring_group_stats) against its bound on the flow's ring, in
per cent: the least time to read the whole (R, P) ring once and write its
group sums, P the family's own parameter count (approx.var_param_dim),
over the device time per launch in the traced window."""

from perfbench import roofline
from perfbench.readers import RING_KERNEL, kernel_time, ring_rows, roofline_share


def read(ctx):
    found = kernel_time(ctx, RING_KERNEL)
    if found is None:
        return None
    seconds, launches = found
    rows, group = ring_rows(ctx)
    n_params = int(ctx["system"].approx.var_param_dim)
    return roofline_share(launches * roofline.ring_group_stats_bound_s(
        rows, n_params, group, ctx["config"]["dtype"]), seconds)
