"""The readers of the program's spans (``benchlib/spans.py`` and the six
metrics over it) on hand-built spans: the window's steps outside the
profiled time, a step without chunks or decode, a request the prefix
cache serves whole, and a program that records no spans; then one tiny
CPU run in which the four host-time metrics add up to ``engine.step_ms``.
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

import servebench_tiny as tiny
from benchlib import spec
from benchlib.stats import percentile

try:
    from repro_torch.serving.metrics import Span
except ImportError:                 # a program that records no spans
    Span = None

pytestmark = pytest.mark.skipif(Span is None,
                                reason="the program records no spans")
MS = 1_000_000                      # ns in a ms
NEW = ["sched.host_ms", "model.decode_host_ms", "model.chunk_host_ms",
       "engine.device_wait_ms", "engine.decode_pad_pct",
       "sched.queue_wait_p95_s"]


def _reader(name):
    return spec.metric_reader(tiny.REPO, name)


class _Spans:
    """Builds a ring's worth of spans by hand, times in ms."""

    def __init__(self):
        self.out = []

    def add(self, name, t0, t1, parent=-1, key=0, attrs=None) -> int:
        i = len(self.out)
        self.out.append(Span(i, name, int(t0 * MS), int(t1 * MS), parent,
                             key, attrs))
        return i

    def step(self, t0, *, chunks=(), decode=None, rows=(0, 0)):
        """A step at ``t0`` ms: ``chunks`` (forward ms, sync ms) pairs, then
        ``decode`` (forward ms, read-back ms); 1 ms of the scheduler's own
        time before each part and after the last."""
        st = self.add("engine.step", t0, t0, attrs={
            "decode_rows": rows[0], "grid_rows": rows[1]})
        t = t0 + 1
        for fwd, sync in chunks:
            c = self.add("model.chunk", t, t + fwd, st)
            self.add("model.chunk.sync", t + fwd - sync, t + fwd, c)
            t += fwd + 1
        if decode is not None:
            fwd, back = decode
            d = self.add("model.decode", t, t + fwd, st)
            self.add("model.decode.readback", t + fwd - back, t + fwd, d)
            self.add("engine.push", t + fwd, t + fwd + 0.5, st)
            t += fwd + 1
        self.out[st] = self.out[st]._replace(end_ns=int(t * MS))
        return t

    def request(self, rid, t0, queue_ms, prefill_ms=0.0):
        r = self.add("req", t0, t0 + queue_ms + prefill_ms + 3, key=rid)
        t = t0
        for name, ms in zip(("req.queue", "req.prefill", "req.handoff_wait",
                             "req.first_token", "req.decode"),
                            (queue_ms, prefill_ms, 1, 1, 1)):
            self.add(name, t, t + ms, r, rid)
            t += ms


def _ctx(spans, w0=0.0, w1=1.0, profiled=None):
    return SimpleNamespace(spans=spans, w0=w0, w1=w1, profiled=profiled)


def test_step_readers_split_each_step_and_sum_to_it():
    s = _Spans()
    s.step(10, chunks=[(20, 5), (10, 2)], decode=(30, 8), rows=(6, 8))
    s.step(100, decode=(20, 4), rows=(6, 8))
    s.step(200)                           # no chunk, no decode
    got = {n: _reader(n)(_ctx(s.out)) for n in NEW[:5]}
    # the steps last 1 + 20 + 1 + 10 + 1 + 30 + 1 = 64 ms, 1 + 20 + 1 = 22
    # ms and 1 ms
    assert got["model.chunk_host_ms"] == pytest.approx((15 + 8) / 3)
    assert got["model.decode_host_ms"] == pytest.approx((22 + 16) / 3)
    assert got["engine.device_wait_ms"] == pytest.approx((5 + 2 + 8 + 4) / 3)
    assert got["sched.host_ms"] == pytest.approx((4 + 2 + 1) / 3)
    step_ms = (64 + 22 + 1) / 3
    assert sum(got[n] for n in NEW[:4]) == pytest.approx(step_ms)
    assert got["engine.decode_pad_pct"] == pytest.approx(100 * 4 / 16)


def test_steps_outside_the_window_or_inside_the_profiled_time_drop_out():
    s = _Spans()
    s.step(10, decode=(10, 1), rows=(4, 4))      # before the window
    s.step(100, decode=(10, 2), rows=(4, 8))     # in
    s.step(200, decode=(50, 40), rows=(4, 4))    # profiled
    s.step(300, decode=(10, 2), rows=(4, 8))     # in
    s.step(400, decode=(10, 3), rows=(4, 4))     # after the window
    ctx = _ctx(s.out, w0=0.05, w1=0.35, profiled=(0.19, 0.26))
    assert _reader("engine.device_wait_ms")(ctx) == pytest.approx(2.0)
    assert _reader("model.decode_host_ms")(ctx) == pytest.approx(8.0)
    assert _reader("engine.decode_pad_pct")(ctx) == pytest.approx(50.0)
    # a step that straddles the profiler's start drops out too
    ctx = _ctx(s.out, w0=0.05, w1=0.35, profiled=(0.105, 0.26))
    assert _reader("engine.device_wait_ms")(ctx) == pytest.approx(2.0)


def test_a_window_of_steps_without_decode_reads_no_padding():
    s = _Spans()
    s.step(100, chunks=[(10, 1)])
    assert _reader("engine.decode_pad_pct")(_ctx(s.out)) is None
    assert _reader("model.decode_host_ms")(_ctx(s.out)) == 0.0
    assert _reader("model.chunk_host_ms")(_ctx(s.out)) == pytest.approx(9)


def test_queue_wait_reads_the_window_requests_outside_the_profiled_time():
    s = _Spans()
    s.request(1, 10, 500)                 # sent before the window
    for rid, t0 in enumerate(range(100, 600, 50), start=2):
        s.request(rid, t0, 40 + rid, prefill_ms=5)
    s.request(99, 400, 0)                 # the cache served it whole
    ctx = _ctx(s.out, w0=0.05, w1=0.7, profiled=(0.31, 0.33))
    waits = sorted([40 + rid for rid, t0 in enumerate(range(100, 600, 50),
                                                      start=2)
                    if not (t0 < 330 and t0 + 40 + rid > 310)] + [0])
    assert _reader("sched.queue_wait_p95_s")(ctx) == pytest.approx(
        percentile([w / 1e3 for w in waits], 95))
    assert len(waits) == 10               # one of the ten sat in the profiler


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the span record: its module has no ``spans``; every
    reader returns None and raises nothing."""
    import repro_torch.serving.metrics as M
    monkeypatch.delattr(M, "spans")
    ctx = SimpleNamespace(w0=0.0, w1=1.0, profiled=None)
    for name in NEW:
        assert _reader(name)(ctx) is None
    assert _reader("sched.host_ms")(_ctx([])) is None


def test_tiny_run_host_times_add_up_to_the_step(tmp_path):
    """A traced CPU run: the six readers report, and the four host-time
    metrics sum to ``engine.step_ms`` within 5%."""
    root = tiny.tiny_root(tmp_path)
    out = tiny.run(root, tiny.CELLS[1], seconds=3.0, trace=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m)
    parts = sum(m[n] for n in NEW[:4])
    assert parts == pytest.approx(m["engine.step_ms"], rel=0.05)
    assert 0 <= m["engine.decode_pad_pct"] < 100
    assert m["sched.queue_wait_p95_s"] >= 0
