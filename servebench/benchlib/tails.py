"""The raw samples of the latency tails, exact (no buckets, no medians of
chunks), over every request sent inside the window: the drain lets each
of them finish, so none is censored. Times are the host's
``perf_counter``: a request's send, and the engine's push of each token
(``RequestOutput.token_times``, after the token's read-back)."""
from __future__ import annotations


def outside_stretch(ctx) -> list:
    """The requests of ``ctx`` that do not overlap the time the profiler
    was on (it slows the host; a traced run's host-clock numbers leave
    that time out)."""
    if not ctx.profiled:
        return list(ctx.requests)
    s0, s1 = ctx.profiled
    return [r for r in ctx.requests if not (r.submitted < s1 and r.done > s0)]


def _end(r, first: bool) -> float:
    if r.failed or not r.times:
        return r.done
    return r.times[0] if first else r.times[-1]


def ttft_samples(ctx, reqs=None) -> list:
    """Send to first token, one per request (a failed one: to its end)."""
    return [_end(r, True) - r.submitted
            for r in (ctx.requests if reqs is None else reqs)]


def request_samples(ctx) -> list:
    """Send to last token, one per request."""
    return [_end(r, False) - r.submitted for r in ctx.requests]


def itl_samples(ctx, reqs=None) -> list:
    """Every gap between consecutive output tokens of the requests."""
    return [b - a for r in (ctx.requests if reqs is None else reqs)
            for a, b in zip(r.times, r.times[1:])]
