"""The step's matrix products against their roofline, in per cent: the
least time of every product the window's steps need (the flow's coupling
nets and the logistic model's two, each bound by its bytes or its
operations at each step's sample count; perfbench/flow_roofline.py) over
the device time of the traced window's GEMM kernels (cuBLAS's, matched by
name)."""

import re

from perfbench import flow_roofline
from perfbench.readers import kernel_time, roofline_share, step_bounds

GEMM_KERNEL = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)


def read(ctx):
    cfg = ctx["config"]
    found = kernel_time(ctx, GEMM_KERNEL)
    if found is None or not ctx["window"].get("steps"):
        return None
    d, n, fam, dtype = (int(cfg["model"]["dim"]), int(cfg["model"]["n_data"]), cfg["family"],
                        cfg["dtype"])
    bound = step_bounds(ctx, lambda S: flow_roofline.matmul_bound_s(
        S, d, fam["n_couplings"], fam["hidden"], dtype)
        + flow_roofline.model_matmul_bound_s(S, d, n, dtype))
    return roofline_share(bound, found[0])
