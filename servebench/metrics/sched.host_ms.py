"""The scheduler's own host time a step: each ``engine.step`` span less
its ``model.chunk`` and ``model.decode`` children (what is left: reaping,
admission, chunk packing, promotion and the handoffs, the token pushes,
the step's bookkeeping), averaged over the window's steps outside the
profiled time, in ms (``benchlib/spans.py``)."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if steps is None:
        return None
    return S.mean_ms([
        S.length_s([st]) - S.length_s(k.get("model.chunk", []))
        - S.length_s(k.get("model.decode", [])) for st, k, _ in steps])
