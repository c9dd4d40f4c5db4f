"""``flash_prefill_paged``'s share of its roofline over the profiled
stretch: the least time the stretch's prefills need of it
(``benchlib/cost.py``: each prompt's new tokens after the prefix the
traffic says the cache serves, over that prefix and themselves, in every
layer, placed evenly over the steps from its send to its first token; the
larger of the bytes over the HBM bandwidth and the operations over the
bf16 peak), over the profiler's device time of its kernels (the split's
merge included), in percent. A stretch with no prefill reads nothing."""
from benchlib import cost


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.sub is None:
        return None
    spent = ctx.trace.class_s.get("flash_prefill_paged", 0.0)
    prefills = cost.prefills_in(ctx.all_reqs, ctx.step_ends, *ctx.sub)
    if spent <= 0 or not prefills:
        return None
    return 100.0 * cost.prefill_bound_s(ctx.hp, prefills, ctx.peaks) / spent
