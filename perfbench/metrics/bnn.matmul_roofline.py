"""The Bayesian neural network's matrix products against their roofline,
in per cent: the least time of every product the window's steps need
(perfbench/bnn_roofline.py: each layer's forward product and weight
gradient, the input gradient of all but the first, at each step's sample
count, each bound by its bytes or its operations) over the device time of
the traced window's GEMM kernels (cuBLAS's, matched by name)."""

import re

from perfbench import bnn_roofline
from perfbench.readers import kernel_time, roofline_share, step_bounds

GEMM_KERNEL = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)


def read(ctx):
    cfg = ctx["config"]
    found = kernel_time(ctx, GEMM_KERNEL)
    if found is None or not ctx["window"].get("steps"):
        return None
    m = cfg["model"]
    bound = step_bounds(ctx, lambda S: bnn_roofline.matmul_bound_s(
        S, m["n_data"], m["in_dim"], m["hidden"], m["classes"], cfg["dtype"]))
    return roofline_share(bound, found[0])
