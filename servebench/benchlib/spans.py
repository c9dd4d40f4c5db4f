"""The program's own spans, cut to what a metric reads.

The port records its spans in one process-wide ring
(``repro_torch.serving.metrics.spans()``: ``index``, ``name``,
``start_ns``, ``end_ns`` on ``perf_counter_ns``, ``parent``, ``key``,
``attrs``), which outlives the engine the harness frees before the
readers run. A program that records none (an older one) reads as None
here, and so do the metrics that read it.

Steps are the ``engine.step`` spans that start inside the window and
miss the profiled time: the steps ``engine.step_ms`` averages. Requests
are the ``req.queue`` spans of the requests sent inside the window that
miss the profiled time.
"""
from __future__ import annotations

NS = 1e9


def program_spans(ctx) -> list | None:
    """``ctx.spans`` when a test hands them in, else the program's ring;
    None when the program records no spans."""
    got = getattr(ctx, "spans", None)
    if got is not None:
        return got
    try:
        from repro_torch.serving.metrics import spans
    except ImportError:
        return None
    return spans()


def _misses_profiled(ctx, s) -> bool:
    if not ctx.profiled:
        return True
    p0, p1 = ctx.profiled
    return s.end_ns / NS <= p0 or s.start_ns / NS >= p1


def steps(ctx) -> list | None:
    """``[(step span, {name: [child spans]}, {name: [grandchild spans]})]``
    of the window's steps outside the profiled time; None when the
    program records no step spans."""
    got = program_spans(ctx)
    if not got:
        return None
    chosen = {s.index: s for s in got if s.name == "engine.step"
              and ctx.w0 < s.start_ns / NS <= ctx.w1
              and _misses_profiled(ctx, s)}
    if not any(s.name == "engine.step" for s in got):
        return None
    kids = {i: {} for i in chosen}
    owner = {}
    for s in got:
        if s.parent in kids:
            kids[s.parent].setdefault(s.name, []).append(s)
            owner[s.index] = s.parent
    grand = {i: {} for i in chosen}
    for s in got:
        if s.parent in owner:
            grand[owner[s.parent]].setdefault(s.name, []).append(s)
    return [(chosen[i], kids[i], grand[i]) for i in sorted(chosen)]


def length_s(spans) -> float:
    """Summed seconds of ``spans``."""
    return sum(s.end_ns - s.start_ns for s in spans) / NS


def mean_ms(per_step) -> float | None:
    """Mean of per-step seconds, in ms; None without steps."""
    return 1e3 * sum(per_step) / len(per_step) if per_step else None


def queue_waits(ctx) -> list | None:
    """Seconds in the queue of each request sent inside the window whose
    queue span misses the profiled time; None when the program records no
    request spans."""
    got = program_spans(ctx)
    if not got:
        return None
    queues = [s for s in got if s.name == "req.queue"]
    if not queues:
        return None
    return [(s.end_ns - s.start_ns) / NS for s in queues
            if ctx.w0 < s.start_ns / NS <= ctx.w1
            and _misses_profiled(ctx, s)]
