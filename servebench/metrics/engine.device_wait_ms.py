"""The time a step the host waits on the card: the ``model.chunk.sync``
spans (the synchronize after each chunk forward) and the
``model.decode.readback`` span (the next tokens' read-back), summed over
the step, averaged over the window's steps outside the profiled time, in
ms (``benchlib/spans.py``). With ``sched.host_ms``,
``model.decode_host_ms`` and ``model.chunk_host_ms`` it adds up to the
mean ``engine.step`` span."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if steps is None:
        return None
    return S.mean_ms([
        S.length_s(g.get("model.chunk.sync", []))
        + S.length_s(g.get("model.decode.readback", []))
        for _, _, g in steps])
