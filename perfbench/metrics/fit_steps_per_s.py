"""Optimizer steps that bbvi completed in the window over the window's
wall time, its end synchronised (host clock)."""


def read(ctx):
    w = ctx["window"]
    return w["steps"] / w["seconds"] if w.get("seconds") else None
