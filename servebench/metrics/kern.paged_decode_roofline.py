"""``paged_decode``'s share of its roofline over the profiled stretch: the
least time the stretch's decode steps need of it (``benchlib/cost.py``:
the larger of every K/V byte the rows read, a prefix that rows share
counted once, plus queries and outputs, over the HBM bandwidth, and the
operations over the bf16 peak), over the profiler's device time of its
kernels (the split's merge included), in percent. The rows and their
positions are the harness's own record of every token served in the
stretch."""
from benchlib import cost


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    spent = ctx.trace.class_s.get("paged_decode", 0.0)
    if spent <= 0:
        return None
    return 100.0 * cost.decode_bound_s(ctx.hp, ctx.steps_sub,
                                       ctx.peaks) / spent
