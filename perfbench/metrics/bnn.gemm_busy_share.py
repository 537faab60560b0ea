"""Per cent of the traced window's busy time (the union of kernel, copy
and set intervals on the card) spent in GEMM kernels (cuBLAS's, matched by
name): whether the Bayesian neural network's products do most of the
step's device work."""

import re

from perfbench.readers import kernel_time

GEMM_KERNEL = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)


def read(ctx):
    found = kernel_time(ctx, GEMM_KERNEL)
    if found is None:
        return None
    busy = ctx["trace"].busy_s()
    return 100.0 * found[0] / busy if busy > 0 else None
