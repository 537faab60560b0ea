"""Milliseconds a vi_diagnostics call spends in the program's span
viabel.diag.cov_norm: the spectral norm of q's covariance inside the
error bounds (an SVD, whose error code torch reads on the host before it
returns, so the span holds the SVD's device time), summed over the
traced window and divided by the window's calls."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans, calls = program_spans(ctx), ctx["window"].get("calls")
    if spans is None or not calls or not spans.count("viabel.diag.cov_norm"):
        return None
    return 1e3 * spans.seconds("viabel.diag.cov_norm") / len(calls)
