"""Kernels the profiler saw on the card in the traced window, copies and
sets left out, per optimizer step of that window."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["window"].get("steps")
    if tr is None or not steps:
        return None
    return len(tr.kernels()) / steps
