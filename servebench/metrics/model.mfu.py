"""The whole step's share of the card's bf16 peak over the window, the
profiler's time left out: the operations the served work needed
(``benchlib/cost.served_flops``: of every prompt, its new tokens after the
prefix the traffic says the cache serves, placed evenly over the steps
from its send to its first token; of every token served, its matrix
products and its attention over its context) over the seconds times the
peak
(``servebench/peaks.json``), in percent."""
from benchlib import cost


def read(ctx):
    if ctx.peaks is None:
        return None
    s0, s1 = ctx.profiled if ctx.profiled else (ctx.w1, ctx.w1)

    def counted(t):
        return ctx.w0 < t <= ctx.w1 and not s0 < t <= s1
    rows = [len(r.call.prompt) + k for r in ctx.all_reqs
            for k, t in enumerate(r.times) if counted(t)]
    # the window's part of each prefill less the profiled stretch's part
    steps = ctx.step_ends
    prefills = cost.prefills_in(ctx.all_reqs, steps, ctx.w0, ctx.w1) + [
        (c, n, -w)
        for c, n, w in cost.prefills_in(ctx.all_reqs, steps, s0, s1)]
    seconds = ctx.window_s - (s1 - s0)
    return 100.0 * cost.served_flops(ctx.hp, prefills, rows) / (
        seconds * ctx.peaks["bf16_flops_per_s"])
