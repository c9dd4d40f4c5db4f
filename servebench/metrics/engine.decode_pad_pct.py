"""Share of the fused decode grid's rows that are padding: over the
window's steps outside the profiled time, the ``engine.step`` spans'
``grid_rows`` (models x the widest model's rows, summed over the fused
groups) less their ``decode_rows``, over ``grid_rows``, in percent
(``benchlib/spans.py``). None when no step decoded."""
from benchlib import spans as S


def read(ctx):
    steps = S.steps(ctx)
    if steps is None:
        return None
    grid = sum(st.attrs["grid_rows"] for st, _, _ in steps)
    rows = sum(st.attrs["decode_rows"] for st, _, _ in steps)
    return 100.0 * (grid - rows) / grid if grid else None
