"""The host's time a step in the decode forward: the ``model.decode``
span (tail pages, the fused plane's inputs and its launches) less its
``model.decode.readback`` child, 0 on a step without decode, averaged
over the window's steps outside the profiled time, in ms
(``benchlib/spans.py``). What a CUDA graph of the decode step can
remove."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if steps is None:
        return None
    return S.mean_ms([
        S.length_s(k.get("model.decode", []))
        - S.length_s(g.get("model.decode.readback", []))
        for _, k, g in steps])
