"""Exact percentiles over raw samples (no buckets, no medians of chunks)."""
from __future__ import annotations

import math


def percentile(samples, q: float) -> float | None:
    """The ``q``-th percentile of ``samples`` by linear interpolation
    between the two nearest ranks of the sorted samples (rank
    ``q / 100 * (n - 1)``, numpy's default method); None for no samples."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        return None
    r = q / 100.0 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)

