"""``itl_p95_s`` read in a traced run, for a cell whose host paces the
tail too unsteadily for an end-to-end bound: the 95th percentile of the
gaps between consecutive output tokens of the window's requests that do
not overlap the profiled stretch."""
from benchlib.stats import percentile
from benchlib.tails import itl_samples, outside_stretch


def read(ctx):
    return percentile(itl_samples(ctx, outside_stretch(ctx)), 95)
