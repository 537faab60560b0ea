"""The Bayesian neural network's whole step as a share of the card's
float32 peak, in per cent: the operations that the window's steps need at
each step's sample count (perfbench/bnn_roofline.py: the networks'
forward products, the weight gradients of every layer, the input
gradients of all but the first, RMSProp), over the window's wall time
and 67 TFLOP/s."""

from perfbench import bnn_roofline, roofline
from perfbench.readers import step_bounds


def read(ctx):
    w, cfg = ctx["window"], ctx["config"]
    if ctx["trace"] is None or not w.get("steps"):
        return None
    m = cfg["model"]
    flops = step_bounds(ctx, lambda S: bnn_roofline.step_flops(
        S, m["n_data"], m["in_dim"], m["hidden"], m["classes"]))
    return 100.0 * flops / w["seconds"] / roofline.PEAK_FLOP_PER_S[cfg["dtype"]]
