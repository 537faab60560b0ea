"""Host syncs per vi_diagnostics call of the traced window: CUDA runtime
calls that block the host made inside the program's viabel. spans,
implicit ones included; the benchmark's own wrappers' synchronisations
are left out (perfbench/program_spans.py)."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans, calls = program_spans(ctx), ctx["window"].get("calls")
    if spans is None or not calls or not spans.count("viabel.vi_diagnostics"):
        return None
    return spans.host_syncs() / len(calls)
