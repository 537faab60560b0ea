"""Per cent of the traced fit window spent inside the program's spans
viabel.step.capture: the host's time recording each sample count's CUDA
graph of a step (viabel_torch.optimizers._GraphedStep), every span the
step opens recorded once inside it. None against a program that opens no
viabel.step.capture span."""

from perfbench.program_spans import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not spans.count("viabel.step.capture") or spans.trace.window_s <= 0:
        return None
    return 100.0 * spans.seconds("viabel.step.capture") / spans.trace.window_s
