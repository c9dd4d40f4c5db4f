"""95th percentile of a request's time from its send to its last token,
over every request sent inside the window: what an agent's next call, or
a client waiting for a whole answer, waits on."""
from benchlib.stats import percentile
from benchlib.tails import request_samples


def read(ctx):
    return percentile(request_samples(ctx), 95)
