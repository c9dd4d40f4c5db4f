"""``output_tok_s`` read in a traced run, for a cell whose host paces the
rate too unsteadily for an end-to-end bound: the tokens delivered in the
window while the profiler was off, over the window's seconds less the
profiler's."""


def read(ctx):
    s0, s1 = ctx.profiled if ctx.profiled else (ctx.w1, ctx.w1)
    n = sum(1 for r in ctx.all_reqs for t in r.times
            if ctx.w0 < t <= ctx.w1 and not s0 < t <= s1)
    return n / (ctx.window_s - (s1 - s0))
