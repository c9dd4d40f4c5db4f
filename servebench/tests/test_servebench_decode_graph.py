"""``model.decode_graph_pct`` on hand-built step spans: 100 with every
decode forward replayed from a graph, 50 with half, None without steps,
without decode forwards, and from a program whose steps lack the
attributes."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

import servebench_tiny as tiny
from benchlib import spec

try:
    from repro_torch.serving.metrics import Span
except ImportError:                 # a program that records no spans
    Span = None

pytestmark = pytest.mark.skipif(Span is None,
                                reason="the program records no spans")
MS = 1_000_000                      # ns in a ms


def _read(steps, w0=0.0, w1=1.0, profiled=None):
    """The metric over one step span per (start ms, attributes)."""
    spans = [Span(i, "engine.step", int(t0 * MS), int((t0 + 5) * MS), -1,
                  i + 1, attrs) for i, (t0, attrs) in enumerate(steps)]
    ctx = SimpleNamespace(spans=spans, w0=w0, w1=w1, profiled=profiled)
    return spec.metric_reader(tiny.REPO, "model.decode_graph_pct")(ctx)


def _attrs(forwards, graphed):
    return {"decode_rows": 4, "grid_rows": 8, "decode_forwards": forwards,
            "decode_graphed": graphed}


def test_every_forward_replayed_reads_100():
    assert _read([(10 + 10 * i, _attrs(1, 1)) for i in range(6)]) == 100.0


def test_half_the_forwards_replayed_reads_50():
    steps = [(10 + 10 * i, _attrs(1, i % 2)) for i in range(6)]
    steps.append((70, _attrs(0, 0)))          # a step without decode
    assert _read(steps) == pytest.approx(50.0)


def test_steps_outside_the_window_or_profiled_drop_out():
    steps = [(10, _attrs(1, 0)), (100, _attrs(1, 1)), (200, _attrs(1, 0)),
             (300, _attrs(1, 1))]
    assert _read(steps, w0=0.05, w1=0.35, profiled=(0.19, 0.26)) == 100.0


def test_no_steps_or_no_decode_reads_none():
    assert _read([]) is None
    assert _read([(10, _attrs(0, 0))]) is None
    assert _read([(10, _attrs(1, 1))], w0=0.5) is None


def test_steps_without_the_attributes_read_none():
    """A program whose steps carry no graph attributes (the parent of the
    decode graphs), or whose metrics are off, reads None and raises
    nothing."""
    assert _read([(10, {"decode_rows": 4, "grid_rows": 8})]) is None
    assert _read([(10, None)]) is None
