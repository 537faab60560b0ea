"""Microseconds a fit step spends on the host: the mean length of the
program's span viabel.step (one optimizer step of a FASO segment, its
ring write included) over the traced window. The span ends when the
host has enqueued the step, not when the card has run it."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not spans.count("viabel.step"):
        return None
    return 1e6 * spans.seconds("viabel.step") / spans.count("viabel.step")
