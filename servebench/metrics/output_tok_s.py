"""Output tokens delivered inside the window over the window's seconds:
every token of any request whose push time falls in the window, over all
of the window's time."""


def read(ctx):
    n = sum(1 for r in ctx.all_reqs for t in r.times
            if ctx.w0 < t <= ctx.w1)
    return n / ctx.window_s
