"""``ttft_p95_s`` read in a traced run, for a cell whose host paces the
tail too unsteadily for an end-to-end bound: the 95th percentile of send
to first token over the window's requests that do not overlap the
profiled stretch."""
from benchlib.stats import percentile
from benchlib.tails import outside_stretch, ttft_samples


def read(ctx):
    return percentile(ttft_samples(ctx, outside_stretch(ctx)), 95)
