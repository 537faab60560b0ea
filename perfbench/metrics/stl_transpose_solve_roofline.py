"""Kernel 2 (stl_transpose_solve, the STL score L^{-T} z) against its
bound, in per cent: one (d, S) solve a step at each step's sample count,
over the device time of the traced window's launches."""

from perfbench import roofline
from perfbench.readers import STL_KERNEL, kernel_time, roofline_share, shapes, step_bounds


def read(ctx):
    found = kernel_time(ctx, STL_KERNEL)
    if found is None or found[1] != ctx["window"]["steps"]:
        return None
    _, d, _, _, dtype = shapes(ctx)
    bound = step_bounds(ctx, lambda S: roofline.tri_solve_bound_s(d, S, dtype))
    return roofline_share(bound, found[0])
