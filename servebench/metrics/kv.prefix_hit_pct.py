"""Share of the prompt tokens admitted in the window that the prefix cache
served: ``prefill_tokens_reused`` over reused plus
``prefill_tokens_computed`` (``EngineStats``, window deltas), in
percent."""


def read(ctx):
    c = ctx.counters_window
    tot = c["prefill_tokens_reused"] + c["prefill_tokens_computed"]
    return 100.0 * c["prefill_tokens_reused"] / tot if tot else None
