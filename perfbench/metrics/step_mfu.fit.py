"""The whole step's share of the card's float32 peak, in per cent: the
operations that the window's steps need, counted from the configuration's
shapes and each step's sample count (perfbench/roofline.py), over the
window's wall time and 67 TFLOP/s."""

from perfbench import roofline
from perfbench.readers import shapes, step_bounds


def read(ctx):
    w = ctx["window"]
    if ctx["trace"] is None or not w.get("steps"):
        return None
    family, d, n, _, dtype = shapes(ctx)
    stl = ctx["system"].stl
    flops = step_bounds(ctx, lambda S: roofline.step_flops(family, S, d, n, stl))
    return 100.0 * flops / w["seconds"] / roofline.PEAK_FLOP_PER_S[dtype]
