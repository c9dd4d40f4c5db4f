"""The host's time a step in the chunk forwards: each ``model.chunk``
span (one a group of equal-length chunks: inputs and launches) less its
``model.chunk.sync`` child, summed over the step, 0 on a step without
chunks, averaged over the window's steps outside the profiled time, in
ms (``benchlib/spans.py``)."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if steps is None:
        return None
    return S.mean_ms([
        S.length_s(k.get("model.chunk", []))
        - S.length_s(g.get("model.chunk.sync", [])) for _, k, g in steps])
