"""Sequences advanced per decode step over the window: the engine's
``decode_tokens`` over its ``decode_steps`` (``EngineStats``), deltas
from the window's opening to its close."""


def read(ctx):
    c = ctx.counters_window
    return c["decode_tokens"] / c["decode_steps"] if c["decode_steps"] \
        else None
