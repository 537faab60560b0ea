"""Host syncs per 1,000 steps of the traced fit window: CUDA runtime calls
that block the host (stream, event or device synchronisation, a blocking
copy) made inside the program's viabel. spans, implicit ones included
(perfbench/program_spans.py)."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans, steps = program_spans(ctx), ctx["window"].get("steps")
    if spans is None or not steps:
        return None
    return 1e3 * spans.host_syncs() / steps
