"""Per cent of the traced fit window in which the card is idle and no
viabel.step span is open on the main thread: the idle that capturing
the step cannot remove (FASO's checks, escalations, RAABBVI's round
ends and regressions, the harness between fits)."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not spans.count("viabel.step") or spans.trace.window_s <= 0:
        return None
    return 100.0 * spans.idle_outside_s("viabel.step") / spans.trace.window_s
