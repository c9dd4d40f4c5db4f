"""95th percentile of the gaps between consecutive output tokens, over
every gap of every request sent inside the window."""
from benchlib.stats import percentile
from benchlib.tails import itl_samples


def read(ctx):
    return percentile(itl_samples(ctx), 95)
