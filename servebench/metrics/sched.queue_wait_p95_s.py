"""95th percentile of a request's wait in the queue: its ``req.queue``
span, from its send to the start of the first chunk forward that computes
any of its tokens (to its promotion when the prefix cache serves all of
it), over the requests sent inside the window whose queue span misses the
profiled time (``benchlib/spans.py``)."""
from benchlib import spans as S
from benchlib.stats import percentile


def read(ctx):
    waits = S.queue_waits(ctx)
    return None if waits is None else percentile(waits, 95)
