"""Share of the fused decode forwards replayed from a CUDA graph: over the
window's steps outside the profiled time, the ``engine.step`` spans'
``decode_graphed`` over their ``decode_forwards``, in percent
(``benchlib/spans.py``). None without steps or decode forwards, and from a
program whose steps carry no such attributes."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if not steps:
        return None
    forwards = graphed = 0
    for st, _, _ in steps:
        attrs = st.attrs or {}
        if "decode_forwards" not in attrs:
            return None
        forwards += attrs["decode_forwards"]
        graphed += attrs["decode_graphed"]
    return 100.0 * graphed / forwards if forwards else None
