"""Milliseconds of host time one R-hat check takes: the program's spans
viabel.faso.rhat_dispatch (the statistics over the ring and the start of
their copy to the host) and viabel.faso.rhat_readback (the verdict's
read and its decisions) summed over the traced window, over the
dispatches."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not spans.count("viabel.faso.rhat_dispatch"):
        return None
    total = spans.seconds("viabel.faso.rhat_dispatch") + spans.seconds(
        "viabel.faso.rhat_readback")
    return 1e3 * total / spans.count("viabel.faso.rhat_dispatch")
