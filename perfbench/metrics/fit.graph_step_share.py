"""Per cent of the traced window's viabel.step spans that hold a
viabel.step.replay span: the fit's steps replayed from a CUDA graph
(viabel_torch.optimizers._GraphedStep) among all its steps. None against
a program that opens no viabel.step.replay span."""

from bisect import bisect_right

from perfbench.program_spans import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not spans.count("viabel.step") or not spans.count("viabel.step.replay"):
        return None
    steps = spans.intervals("viabel.step")
    starts = [start for start, _ in steps]
    holding = set()
    for start, end in spans.intervals("viabel.step.replay"):
        i = bisect_right(starts, start) - 1
        if i >= 0 and steps[i][1] >= end:
            holding.add(i)
    return 100.0 * len(holding) / len(steps)
