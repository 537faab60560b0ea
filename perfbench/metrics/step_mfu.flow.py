"""The flow's whole step as a share of the card's float32 peak, in per
cent: the operations that the window's steps need at each step's sample
count (perfbench/flow_roofline.py: the coupling nets' matrix products,
the model and its gradient, RMSProp), over the window's wall time and
67 TFLOP/s."""

from perfbench import flow_roofline, roofline
from perfbench.readers import step_bounds


def read(ctx):
    w, cfg = ctx["window"], ctx["config"]
    if ctx["trace"] is None or not w.get("steps"):
        return None
    d, n, fam = int(cfg["model"]["dim"]), int(cfg["model"]["n_data"]), cfg["family"]
    flops = step_bounds(ctx, lambda S: flow_roofline.step_flops(
        S, d, n, fam["n_couplings"], fam["hidden"]))
    return 100.0 * flops / w["seconds"] / roofline.PEAK_FLOP_PER_S[cfg["dtype"]]
