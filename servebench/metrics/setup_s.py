"""Seconds from the process's start to the window's opening: imports, the
weights, the engine, the kernels' first load (and build, in a fresh
checkout), the sessions' histories and the first calls."""


def read(ctx):
    return ctx.setup_s
