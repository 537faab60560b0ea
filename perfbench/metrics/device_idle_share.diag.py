"""Per cent of the traced front-door window in which no kernel, copy or set ran
on the card."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
