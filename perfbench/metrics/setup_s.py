"""Seconds from the process's start to the window's: imports, the card's
start, the kernel library's load (its build on a first run), the data,
and the traffic's set-up (the checked first steps, warm-up, a fitted q)."""


def read(ctx):
    return ctx["setup_s"]
