"""Milliseconds a vi_diagnostics call spends in the span diag.psis: the
benchmark's wrapper around the program's function (traffic file
``spans``), synchronised at its end, summed over the traced window
and divided by the window's calls."""


def read(ctx):
    spans, calls = ctx["spans"], ctx["window"].get("calls")
    if not calls or not spans.calls.get("diag.psis"):
        return None
    return 1e3 * spans.seconds["diag.psis"] / len(calls)
