"""Kernel 1 (ring_group_stats) against its bound, in per cent: the least
time to read the whole (R, D) ring once and write its group sums, over
the device time per launch in the traced window."""

from perfbench import roofline
from perfbench.readers import RING_KERNEL, kernel_time, ring_rows, roofline_share, shapes


def read(ctx):
    found = kernel_time(ctx, RING_KERNEL)
    if found is None:
        return None
    seconds, launches = found
    _, _, _, n_params, dtype = shapes(ctx)
    rows, group = ring_rows(ctx)
    return roofline_share(launches * roofline.ring_group_stats_bound_s(
        rows, n_params, group, dtype), seconds)
