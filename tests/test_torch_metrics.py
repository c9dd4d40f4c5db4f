"""The port's observability surface (repro_torch.serving.metrics, a copy of
the reference module) and its engine hooks.

- unit tests of tests/test_metrics.py on the port's copy, plus the port's
  and the reference's Histogram, registry export and Prometheus text equal
  on the same observations;
- the engine tests of tests/test_metrics.py:138, 161, 193, 255 and 296 on
  the port's CPU engine (weights carried across from the reference's init):
  metrics=False leaves greedy and sampled tokens unchanged, trace spans in
  causal order with TTFT on RequestOutput's clock, abort closes the trace
  at every stage, the exposition lints clean, and ``engine.stats`` is a
  view over the registry's counters.
"""
import math
import tracemalloc

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving import metrics as RM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.params import params_from_numpy
from repro_torch.serving import LocalDisaggEngine, SamplingParams
from repro_torch.serving import metrics as TM
from repro_torch.serving.metrics import (SPAN_ABORTED, SPAN_CHUNK,
                                         SPAN_FINISHED, SPAN_FIRST_TOKEN,
                                         SPAN_HANDOFF, SPAN_QUEUED,
                                         SPAN_ROUTED, SPAN_TOKEN, Histogram,
                                         MetricsRegistry, NullGauge,
                                         NullHistogram, lint_prometheus)

CFG_KW = dict(name="metrics-eng", arch_type="dense", n_layers=2,
              d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
              dtype="float32")


@pytest.fixture(scope="module")
def weights():
    cfg = ModelConfig(**CFG_KW)

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return (TModelConfig(**CFG_KW),
            bridge(jax_init_params(cfg, jax.random.PRNGKey(0))),
            bridge(jax_init_params(cfg, jax.random.PRNGKey(7))))


def _engine(weights, **kw):
    cfg, base, dec = weights
    kw.setdefault("num_pages", 128)
    kw.setdefault("page_size", 8)
    eng = LocalDisaggEngine(cfg, base, device="cpu", **kw)
    eng.models.register("m0", dec)
    return eng


# ----------------------------------------------------------------------
# the module itself


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_percentiles_vs_numpy_and_reference(dist):
    """Interpolated log-bucket percentiles track numpy within the bucket
    growth factor, and equal the reference module's on the same samples."""
    rng = np.random.default_rng(0)
    xs = {"lognormal": rng.lognormal(-2.0, 1.5, size=5000),
          "uniform": rng.uniform(1e-4, 10.0, size=5000),
          "exponential": rng.exponential(0.05, size=5000)}[dist]
    growth = 1.25
    h = Histogram("h", lo=1e-6, hi=4e3, growth=growth)
    r = RM.Histogram("h", lo=1e-6, hi=4e3, growth=growth)
    for x in xs:
        h.observe(float(x))
        r.observe(float(x))
    assert h.count == len(xs)
    assert h.sum == pytest.approx(float(xs.sum()), rel=1e-9)
    for q in (50, 90, 95, 99):
        est, ref = h.percentile(q), float(np.percentile(xs, q))
        assert abs(est - ref) <= (growth - 1.0) * ref + 1e-12, (q, est, ref)
        assert est == r.percentile(q)
    assert h.snapshot() == r.snapshot()
    assert h.cumulative_buckets() == r.cumulative_buckets()


def test_histogram_edge_cases():
    h = Histogram("h")
    assert math.isnan(h.percentile(50))
    assert math.isnan(h.mean)
    h.observe(0.5)
    assert h.percentile(0) == h.percentile(50) == h.percentile(100) == 0.5
    h.observe(1e-9)
    h.observe(1e6)
    assert h.count == 3
    assert h.percentile(100) == 1e6
    snap = h.snapshot()
    assert snap["count"] == 3 and snap["min"] == 1e-9 and snap["max"] == 1e6


def test_histogram_cumulative_buckets_monotone():
    rng = np.random.default_rng(1)
    h = Histogram("h")
    for x in rng.lognormal(0.0, 2.0, size=1000):
        h.observe(float(x))
    buckets = h.cumulative_buckets()
    assert math.isinf(buckets[-1][0])
    assert buckets[-1][1] == h.count
    cums = [c for _, c in buckets]
    assert cums == sorted(cums)


def test_registry_typed_factories_and_conflicts():
    reg = MetricsRegistry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    assert reg.gauge("g", labels={"k": "a"}) is not reg.gauge(
        "g", labels={"k": "b"})


def test_disabled_registry_null_singletons_counters_real():
    reg = MetricsRegistry(enabled=False)
    h1, h2 = reg.histogram("h1"), reg.histogram("h2")
    assert isinstance(h1, NullHistogram) and h1 is h2
    assert isinstance(reg.gauge("g"), NullGauge)
    assert math.isnan(h1.percentile(95))
    c = reg.counter("c_total")
    c.inc(3)
    assert reg.counter("c_total").value == 3


def test_disabled_observe_is_allocation_free():
    reg = MetricsRegistry(enabled=False)
    h, g = reg.histogram("h"), reg.gauge("g")
    v = 0.125
    h.observe(v)
    g.set(v)
    spins = [None] * 1000
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in spins:
            h.observe(v)
            g.set(v)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    leaked = sum(s.size_diff for s in after.compare_to(before, "lineno")
                 if "test_torch_metrics" in (s.traceback[0].filename or ""))
    assert leaked == 0, f"disabled-mode sampling allocated {leaked} bytes"


def test_trace_ring_bounded():
    reg = MetricsRegistry(trace_capacity=4)
    for rid in range(10):
        reg.start_trace(rid)
    assert [t.rid for t in reg.traces()] == [6, 7, 8, 9]


def test_lint_prometheus_catches_format_bugs():
    assert lint_prometheus(
        "# HELP a_total ok\n# TYPE a_total counter\na_total 1\n") == []
    bad = ("# HELP a_total ok\n# TYPE a_total counter\n"
           "a_total 1\na_total 2\n")
    assert any("duplicate series" in p for p in lint_prometheus(bad))
    assert any("no TYPE" in p for p in lint_prometheus("b_total 1\n"))
    bad = "# HELP g ok\n# TYPE g gauge\ng NaNopeNope\n"
    assert any("non-numeric" in p for p in lint_prometheus(bad))
    bad = ("# HELP h ok\n# TYPE h histogram\n"
           'h_bucket{le="1.0"} 1\nh_sum 1\nh_count 1\n')
    assert any("+Inf" in p for p in lint_prometheus(bad))
    bad = ("# HELP h ok\n# TYPE h histogram\n"
           'h_bucket{le="1.0"} 5\nh_bucket{le="+Inf"} 3\n'
           "h_sum 1\nh_count 3\n")
    assert any("decrease" in p for p in lint_prometheus(bad))


def test_exposition_equals_the_reference_modules():
    """The same instruments and observations render the same Prometheus
    text in both packages (the port's module is a copy)."""
    texts = []
    for mod in (RM, TM):
        reg = mod.MetricsRegistry()
        reg.counter("c_total", "c").inc(5)
        reg.gauge("g", "g", labels={"k": "a"}).set(2.5)
        h = reg.histogram("h_seconds", "h", lo=1e-3, hi=10.0)
        for x in np.random.default_rng(2).exponential(0.3, 200):
            h.observe(float(x))
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]
    assert lint_prometheus(texts[1]) == []


# ----------------------------------------------------------------------
# the engine


def test_disabled_engine_identical_tokens(weights):
    """tests/test_metrics.py:138: metrics=False changes no token, greedy or
    sampled, and registers no histogram and keeps no trace."""
    rng = np.random.default_rng(2)
    ctxs = [list(rng.integers(4, 60, size=18 + i)) for i in range(3)]
    params = [SamplingParams(max_tokens=6),
              SamplingParams(max_tokens=6, temperature=0.9, seed=4),
              SamplingParams(max_tokens=6, temperature=1.1, top_k=9)]
    streams = []
    for metrics in (True, False):
        eng = _engine(weights, metrics=metrics)
        outs = [eng.generate("m0", c, p) for c, p in zip(ctxs, params)]
        eng.run()
        streams.append([list(o.tokens) for o in outs])
        if not metrics:
            snap = eng.metrics()
            assert snap["histograms"] == {} and snap["traces"] == []
            assert snap["counters"]["engine_decode_tokens_total"] == 18
    assert streams[0] == streams[1]


def test_trace_span_ordering_and_ttft(weights):
    """tests/test_metrics.py:161."""
    eng = _engine(weights, chunked=True, chunk_size=8, token_budget=64)
    rng = np.random.default_rng(3)
    out = eng.generate("m0", list(rng.integers(4, 60, size=20)),
                       SamplingParams(max_tokens=5))
    eng.run()
    assert out.finished
    (tr,) = [t for t in eng.metrics_registry.traces()
             if t.rid == out.request_id]
    assert tr.done
    names = [n for n, _, _ in tr.events]
    for a, b in [(SPAN_QUEUED, SPAN_ROUTED), (SPAN_ROUTED, SPAN_CHUNK),
                 (SPAN_CHUNK, SPAN_HANDOFF), (SPAN_HANDOFF, SPAN_FIRST_TOKEN),
                 (SPAN_FIRST_TOKEN, SPAN_FINISHED)]:
        assert names.index(a) < names.index(b), names
    assert names.count(SPAN_TOKEN) == len(out.tokens) - 1
    times = [t for _, t, _ in tr.events]
    assert times == sorted(times)
    assert tr.ttft_s == pytest.approx(out.ttft, abs=5e-3)
    snap = eng.metrics()["histograms"]["engine_ttft_seconds"]
    assert snap["count"] == 1
    assert snap["min"] <= out.ttft <= snap["max"] + 1e-12
    itl = eng.metrics()["histograms"]["engine_itl_seconds"]
    assert itl["count"] == len(out.tokens) - 1


def test_abort_closes_trace_at_every_stage(weights):
    """tests/test_metrics.py:193: queued, prefilling, decoding; a finished
    request is not terminated twice."""
    eng = _engine(weights, chunked=True, chunk_size=4, token_budget=16)
    rng = np.random.default_rng(4)

    def mk(n):
        return list(rng.integers(4, 60, size=n))

    def trace_of(out):
        (tr,) = [t for t in eng.metrics_registry.traces()
                 if t.rid == out.request_id]
        return tr

    q = eng.generate("m0", mk(24), SamplingParams(max_tokens=4))
    assert eng.abort(q)
    assert trace_of(q).events[-1][0] == SPAN_ABORTED and trace_of(q).done

    p = eng.generate("m0", mk(40), SamplingParams(max_tokens=4))
    eng.step()
    assert any(r.rid == p.request_id for r in eng.scheduler.prefilling)
    assert eng.abort(p)
    tr = trace_of(p)
    assert tr.events[-1][0] == SPAN_ABORTED and tr.done
    assert any(n == SPAN_CHUNK for n, _, _ in tr.events)

    d = eng.generate("m0", mk(12), SamplingParams(max_tokens=8))
    while not d.tokens and not d.finished:
        eng.step()
    assert eng.abort(d)
    tr = trace_of(d)
    assert tr.events[-1][0] == SPAN_ABORTED and tr.done
    assert any(n == SPAN_FIRST_TOKEN for n, _, _ in tr.events)

    f = eng.generate("m0", mk(10), SamplingParams(max_tokens=2))
    eng.run()
    assert f.finished and not eng.abort(f)
    tr = trace_of(f)
    assert tr.events[-1][0] == SPAN_FINISHED
    tr.event(SPAN_TOKEN)
    assert tr.events[-1][0] == SPAN_FINISHED


def test_render_prometheus_lints_clean_and_carries_series(weights):
    """tests/test_metrics.py:255."""
    eng = _engine(weights)
    rng = np.random.default_rng(5)
    outs = [eng.generate("m0", list(rng.integers(4, 60, size=16 + i)),
                         SamplingParams(max_tokens=4)) for i in range(2)]
    eng.run()
    assert all(o.finished for o in outs)
    text = eng.render_prometheus()
    assert lint_prometheus(text) == []
    for series in ("engine_ttft_seconds_bucket", "engine_ttft_seconds_count",
                   "engine_itl_seconds_sum", "engine_pool_free_pages",
                   "engine_decode_tokens_total", "engine_router_picks_total",
                   "engine_handoff_seconds_count",
                   "engine_queue_depth_count"):
        assert series in text, series
    assert f"engine_pool_free_pages {eng.block_pool.free_count}" in text
    h = eng.metrics()["histograms"]
    assert h["engine_decode_batch"]["count"] == eng.stats.decode_steps
    assert h["engine_handoff_plan_bytes"]["count"] == eng.stats.handoffs


def test_stats_surface_still_runs_on_registry_counters(weights):
    """tests/test_metrics.py:296."""
    eng = _engine(weights)
    rng = np.random.default_rng(6)
    out = eng.generate("m0", list(rng.integers(4, 60, size=16)),
                       SamplingParams(max_tokens=3))
    eng.run()
    assert out.finished
    snap = eng.metrics()["counters"]
    assert snap["engine_handoffs_total"] == eng.stats.handoffs > 0
    assert snap["engine_decode_tokens_total"] == eng.stats.decode_tokens > 0
    assert eng.stats()["decode_tokens"] == eng.stats.decode_tokens
