"""The yardstick: the card's peaks and the operations and bytes that a call
needs, counted from its shapes whatever implements it.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full 700 W
(dense, no sparsity): 3.35 TB/s of HBM bandwidth, 67 TFLOP/s in float32
outside the tensor cores and 34 TFLOP/s in float64. A bound counts each
input byte read once and each output byte written once.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
_SIZE = {"float32": 4, "float64": 8}


def bound_s(nbytes, flops, dtype):
    """Least seconds for ``nbytes`` of traffic and ``flops`` operations."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


def ring_group_stats_bound_s(R, D, group, dtype):
    """Kernel 1: the (R, D) ring and the (D,) center read once, the two
    (R / group, D) sums written once; three operations an element."""
    size = _SIZE[dtype]
    nbytes = (R * D + D + 2 * (R // group) * D) * size
    return bound_s(nbytes, 3 * R * D, dtype)


def tri_solve_bound_s(d, S, dtype):
    """Kernels 2 and 3: a (d, d) triangle and the (d, S) right-hand side
    read once, the (d, S) solution written once; d^2 S operations (d(d-1)/2
    multiply-adds and d scalings a column)."""
    size = _SIZE[dtype]
    return bound_s((d * (d + 1) // 2 + 2 * d * S) * size, d * d * S, dtype)


def logistic_regression_flops(S, d, n):
    """Log density and its gradient at S draws: the (S, d) x (d, n)
    logits forward and the (S, n) x (n, d) product back, plus about ten
    operations a logit and four a coordinate."""
    return 4 * S * d * n + 10 * S * n + 4 * S * d


def step_flops(family, S, d, n, stl):
    """One ExclusiveKL + RMSProp step on Bayesian logistic regression.

    Full rank: the draws ``mu + z L^T`` (2 S d^2) and their gradient with
    respect to L (2 S d^2), the STL score ``L^{-T} z`` (d^2 S) when
    ``stl``. RMSProp makes about six operations a parameter, and the
    model as above.
    """
    if family == "FullRankGaussian":
        n_params = d + d * d
        flops = 4 * S * d * d + (d * d * S if stl else 0)
    else:
        raise ValueError(f"no operation count for the family {family!r}")
    return flops + logistic_regression_flops(S, d, n) + 6 * n_params
