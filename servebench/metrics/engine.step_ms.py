"""Mean wall time of one engine step: the harness's ``perf_counter``
around each ``eng.step()`` (which ends in the decode tokens' read-back),
summed over the window's steps and divided by their count; the steps of
the profiled stretch are left out (the profiler slows the host)."""


def read(ctx):
    return 1e3 * sum(ctx.step_s) / len(ctx.step_s) if ctx.step_s else None
