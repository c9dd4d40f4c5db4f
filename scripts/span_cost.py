"""The host cost of the span record (``serving/metrics.py``), in
microseconds a call, the best of five means of many calls: an open and
close pair with no profiler running, the same with a step's attributes, a
finished span added, the shared no-op's pair, and the per-token trace
event the decode loop no longer records.

    python3 scripts/span_cost.py
"""
import json
import sys
import time
from pathlib import Path

N = 300_000


def per_call_us(fn) -> float:
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        dt = (time.perf_counter() - t0) / N * 1e6
        best = dt if best is None else min(best, dt)
    return best


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.serving import metrics as M

    rec, null = M.SpanRecord(), M.NULL_SPANS
    reg = M.MetricsRegistry()
    trace = reg.start_trace(1)

    def pairs():
        for _ in range(N):
            rec.close(rec.open(M.SPAN_PUSH), None)

    def pairs_attrs():
        for _ in range(N):
            i = rec.open(M.SPAN_STEP, 3)
            rec.close(i, {"decode_rows": 64, "grid_rows": 68,
                          "chunk_tokens": 0, "chunk_forwards": 0, "held": 0,
                          "stalls": 0})

    def adds():
        for _ in range(N):
            rec.add(M.REQUEST_PHASES[0], 1, 2, 5, 7)

    def null_pairs():
        for _ in range(N):
            null.close(null.open(M.SPAN_PUSH), None)

    def token_events():
        for _ in range(N):
            reg.trace(1).event(M.SPAN_TOKEN, t=1.0)
            if len(trace.events) > 1000:
                trace.events.clear()

    def empty():
        for _ in range(N):
            pass

    base = per_call_us(empty)
    print(json.dumps({k: per_call_us(f) - base for k, f in (
        ("open_close_us", pairs), ("open_close_attrs_us", pairs_attrs),
        ("add_us", adds), ("null_open_close_us", null_pairs),
        ("token_event_us", token_events))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
