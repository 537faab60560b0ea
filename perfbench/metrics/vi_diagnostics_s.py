"""The window's wall time over the vi_diagnostics calls completed in it,
each ending in a synchronisation (host clock)."""


def read(ctx):
    w = ctx["window"]
    return w["seconds"] / len(w["calls"]) if w.get("calls") else None
