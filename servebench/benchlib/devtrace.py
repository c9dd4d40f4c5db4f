"""The traced sub-window: torch.profiler's records reduced to numbers.

The harness profiles a fixed stretch of the measured window (CPU and CUDA
activity), marking it with a ``bench.window`` annotation, each engine step
with ``bench.step`` and each request sent with ``bench.generate``. This
module reads the profiler's raw records (no timeline is exported) and
gives:
  - ``busy_s``: the union of the device's kernel and copy intervals inside
    the marked stretch, so overlapping kernels count once;
  - ``window_s``: the marked stretch's length;
  - ``longest_gap_s``: the longest stretch of the window with no device
    work, edges included (``consistent`` reads it);
  - device seconds by kernel class (``kernel_class``) and by kernel name;
  - the idle gaps between busy intervals, each charged to the innermost
    host-side record that was running at the gap's midpoint (the
    annotation, an aten op or a CUDA runtime call), summed by that name.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

ANNOTATION = "bench."
WINDOW = "bench.window"
STEP = "bench.step"
GENERATE = "bench.generate"
#: gaps shorter than this are summed as one entry (launch spacing)
SHORT_GAP_NS = 20_000
#: every traced step launches work and ends in a read-back, so the device
#: cannot idle much longer than the longest step; a trace with a longer
#: gap than this floor and three such steps has lost or misplaced records
GAP_FLOOR_S = 0.5
NAME_CHARS = 120


def kernel_class(name: str) -> str:
    """A kernel's class by its name (copied from the port's
    ``launch/profile.py``). The split's merge kernel
    (``csrc/merge_splits.cuh``) is a template on a tag that names its
    caller, ``paged_decode_merge`` or ``flash_prefill_paged_merge``, and is
    counted with that caller."""
    n = name.lower()
    if "paged_decode" in n:
        return "paged_decode"
    if "paged_write" in n:
        return "paged_write"
    if "flash_prefill_paged" in n:
        return "flash_prefill_paged"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma",
                            "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    return "other"


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    longest_gap_s: float = 0.0
    class_s: dict = field(default_factory=dict)
    ops: list = field(default_factory=list)        # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)  # [[host name, s]] top 10


def _records(prof):
    """``(name, is_device, start_ns, end_ns)`` of every raw record."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def reduce(prof) -> DeviceTrace | None:
    """The sub-window's numbers; None when the profiler recorded no device
    activity (a CPU run, or a trace that came back empty)."""
    return reduce_records(_records(prof))


def reduce_records(recs) -> DeviceTrace | None:
    """``reduce`` over ``(name, is_device, start_ns, end_ns)`` records."""
    win = [r for r in recs if not r[1] and r[0] == WINDOW]
    # the harness's annotations are mirrored on the device's timeline:
    # they are spans of the host's, not device work
    dev = [r for r in recs if r[1] and not r[0].startswith(ANNOTATION)]
    if not win or not dev:
        return None
    w0, w1 = win[0][2], win[0][3]
    class_ns: dict = {}
    name_ns: dict = {}
    spans = []
    for name, _, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        c = kernel_class(name)
        class_ns[c] = class_ns.get(c, 0) + (e - s)
        key = name[:NAME_CHARS]
        name_ns[key] = name_ns.get(key, 0) + (e - s)
    busy = _merge(spans)
    busy_ns = sum(e - s for s, e in busy)

    host = sorted((s, e, name) for name, is_dev, s, e in recs
                  if not is_dev and name != WINDOW and e > s)
    starts = [h[0] for h in host]
    gap_ns: dict = {}
    longest = 0
    edges = [w0] + [x for se in busy for x in se] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        longest = max(longest, g1 - g0)
        if g1 - g0 < SHORT_GAP_NS:
            key = f"short gaps (<{SHORT_GAP_NS // 1000} us)"
        else:
            key = "host (no record)"
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    key = host[j][2][:NAME_CHARS]
                    break
        gap_ns[key] = gap_ns.get(key, 0) + (g1 - g0)
    return DeviceTrace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        longest_gap_s=longest / 1e9,
        class_s={k: v / 1e9 for k, v in class_ns.items()},
        ops=[[k, v / 1e9] for k, v in _top(name_ns)],
        idle_gaps=[[k, v / 1e9] for k, v in _top(gap_ns)])


def consistent(t: DeviceTrace | None, longest_step_s: float) -> bool:
    """Whether a trace of steps no longer than ``longest_step_s`` holds
    their device work: it has device records, and no gap in them is longer
    than ``GAP_FLOOR_S`` and three steps."""
    return t is not None and t.longest_gap_s <= max(GAP_FLOOR_S,
                                                    3 * longest_step_s)
