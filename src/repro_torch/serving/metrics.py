"""Observability control plane: typed metrics + per-request lifecycle traces.

Port of ``repro.serving.metrics``: a copy (the module is pure Python), kept
here because the port imports nothing of the reference package.

The paper's headline claims are TAIL-LATENCY claims (4.5x lower p95, 3.9x
higher throughput), so the engine needs a first-class latency/occupancy
surface — not a counter grab-bag. This module is that surface:

  - ``Counter`` / ``Gauge`` / ``Histogram``: typed primitives. Histograms use
    FIXED log-spaced buckets (geometric bounds), so ``observe`` is one bisect
    + one int increment — no per-sample storage, O(1) memory regardless of
    traffic — and export p50/p95/p99 by interpolating inside the owning
    bucket (relative error bounded by the bucket growth factor; see
    ``Histogram.percentile``). Gauges may be value-set or COLLECTOR-backed
    (``fn=``): the callable is sampled at snapshot/render time, which is how
    pool occupancy, radix-tree size, and queue depths publish without any
    hot-path writes.
  - ``RequestTrace``: one request's lifecycle as timestamped span events —
    queued -> routed -> chunk_prefilled (per chunk) -> handoff ->
    first_token -> token (per-token ITL) -> finished | aborted — recorded at
    the SAME push points ``RequestOutput`` already timestamps, so trace
    timings are exactly what a streaming client observes. Traces are kept in
    a bounded ring (``trace_capacity``); abort at ANY stage closes the trace
    with an ``aborted`` terminal event.
  - ``MetricsRegistry``: the one sink the engine, router, scheduler, pool,
    and prefix index publish into. Exported two ways: ``snapshot()`` as
    structured dicts (what ``engine.metrics()`` returns) and
    ``render_prometheus()`` as Prometheus text exposition (the
    production-stack router/KEDA scrape pattern). ``lint_prometheus``
    validates the exposition format (CI gate: no duplicate/unnamed series).

Disabled mode (``MetricsRegistry(enabled=False)``): histograms, gauges, and
traces degrade to shared no-op singletons whose methods take fixed-arity
arguments (no ``*args`` tuple build), so the decode hot loop pays one
attribute lookup + one no-op call and ZERO allocations per would-be sample
(asserted in tests/test_metrics.py and tests/test_torch_metrics.py). Counters stay REAL even when disabled:
they back the pre-existing ``engine.stats()`` counter surface, which must
keep working with observability off.
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from collections import OrderedDict

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestTrace",
    "NullHistogram", "NullGauge", "NullTrace", "lint_prometheus",
    "SPAN_QUEUED", "SPAN_ROUTED", "SPAN_CHUNK", "SPAN_HANDOFF",
    "SPAN_FIRST_TOKEN", "SPAN_TOKEN", "SPAN_FINISHED", "SPAN_ABORTED",
]

# trace span-event names (one vocabulary, engine-wide)
SPAN_QUEUED = "queued"
SPAN_ROUTED = "routed"
SPAN_CHUNK = "chunk_prefilled"
SPAN_HANDOFF = "handoff"
SPAN_FIRST_TOKEN = "first_token"
SPAN_TOKEN = "token"
SPAN_FINISHED = "finished"
SPAN_ABORTED = "aborted"

#: terminal events — a trace is closed once it carries one of these
_TERMINAL = (SPAN_FINISHED, SPAN_ABORTED)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats repr-exact."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonic counter. ``value`` is readable/writable directly so the
    legacy ``EngineStats`` attribute surface can be re-implemented as a thin
    view over registry counters (``stats.handoffs += 1`` keeps working)."""

    __slots__ = ("name", "help", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value: ``set()`` it, or back it with a collector
    callable (``fn=``) sampled at snapshot/render time."""

    __slots__ = ("name", "help", "labels", "value", "fn")
    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: tuple = (),
                 fn=None):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        if self.fn is not None:
            return float(self.fn())
        return self.value


class Histogram:
    """Fixed log-bucket histogram with interpolated percentile export.

    Bucket upper bounds are geometric: ``lo * growth**i`` up to ``hi``, plus
    a +Inf overflow bucket; values at or below ``lo`` land in bucket 0.
    ``observe`` is a bisect into the (precomputed) bounds plus one integer
    increment — no per-sample storage. ``percentile`` walks the cumulative
    counts to the owning bucket and interpolates linearly inside it, clamped
    to the observed [min, max], so the estimate's relative error is bounded
    by the bucket growth factor (default 1.25 => <= 25% worst case,
    typically far less — gated against numpy quantiles in
    tests/test_metrics.py)."""

    __slots__ = ("name", "help", "labels", "bounds", "counts", "count",
                 "sum", "_min", "_max")
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: tuple = (), *,
                 lo: float = 1e-6, hi: float = 4e3, growth: float = 1.25):
        assert lo > 0 and hi > lo and growth > 1.0
        self.name = name
        self.help = help
        self.labels = labels
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self.bounds = [lo * growth ** i for i in range(n + 1)]
        self.counts = [0] * (len(self.bounds) + 1)   # [+Inf overflow at -1]
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def percentile(self, q: float) -> float:
        """q in [0, 100]. NaN when empty."""
        if self.count == 0:
            return float("nan")
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo_edge = self.bounds[i - 1] if i > 0 else 0.0
                hi_edge = (self.bounds[i] if i < len(self.bounds)
                           else self._max)
                frac = (target - cum) / c
                est = lo_edge + (hi_edge - lo_edge) * max(frac, 0.0)
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self._min if self.count else float("nan"),
            "max": self._max if self.count else float("nan"),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def cumulative_buckets(self):
        """(upper_bound, cumulative_count) pairs, +Inf last — the Prometheus
        histogram exposition layout. Zero-count buckets are skipped (bounded
        output) except +Inf, which is always present."""
        out = []
        cum = 0
        for i, c in enumerate(self.counts[:-1]):
            cum += c
            if c:
                out.append((self.bounds[i], cum))
        out.append((math.inf, cum + self.counts[-1]))
        return out


# ----------------------------------------------------------------------
# disabled-mode singletons: fixed-arity no-op methods (NO *args tuple
# build), shared instances (no per-call or per-metric allocation)


class NullHistogram:
    __slots__ = ()
    kind = "histogram"

    def observe(self, v):
        pass

    def percentile(self, q):
        return float("nan")

    def snapshot(self):
        return {"count": 0, "sum": 0.0}


class NullGauge:
    __slots__ = ()
    kind = "gauge"

    def set(self, v):
        pass

    def snapshot(self):
        return 0.0


class NullTrace:
    __slots__ = ()

    def event(self, name, t=None, **attrs):
        pass

    def close(self, reason, t=None):
        pass


_NULL_HISTOGRAM = NullHistogram()
_NULL_GAUGE = NullGauge()
_NULL_TRACE = NullTrace()


# ----------------------------------------------------------------------


class RequestTrace:
    """One request's lifecycle as timestamped span events.

    ``events`` is a list of ``(name, t, attrs)`` tuples in record order;
    ``t`` is ``time.perf_counter()`` at record time — the SAME clock (and,
    for first_token/token, the same timestamps) ``RequestOutput`` exposes.
    ``close(reason)`` appends the terminal event exactly once (idempotent:
    a finished trace ignores later events, so an abort racing a finish
    cannot double-terminate)."""

    __slots__ = ("rid", "model_id", "events", "done")

    def __init__(self, rid: int, model_id=None, t: float | None = None):
        self.rid = rid
        self.model_id = model_id
        self.events: list = []
        self.done = False
        self.event(SPAN_QUEUED, t=t)

    def event(self, name: str, t: float | None = None, **attrs) -> None:
        if self.done:
            return
        self.events.append((name, time.perf_counter() if t is None else t,
                            attrs or None))
        if name in _TERMINAL:
            self.done = True

    def close(self, reason: str, t: float | None = None) -> None:
        """Terminal event: ``finished`` (reason attr) or ``aborted``."""
        if reason == "abort":
            self.event(SPAN_ABORTED, t=t)
        else:
            self.event(SPAN_FINISHED, t=t, reason=reason)

    # -- derived spans --------------------------------------------------
    def _t(self, name: str) -> float | None:
        for n, t, _ in self.events:
            if n == name:
                return t
        return None

    def span(self, start: str, end: str) -> float | None:
        """Seconds between the first occurrence of two events."""
        a, b = self._t(start), self._t(end)
        return (b - a) if a is not None and b is not None else None

    @property
    def ttft_s(self) -> float | None:
        return self.span(SPAN_QUEUED, SPAN_FIRST_TOKEN)

    def as_dict(self) -> dict:
        return {
            "rid": self.rid,
            "model_id": self.model_id,
            "done": self.done,
            "events": [
                {"name": n, "t": t, **(attrs or {})}
                for n, t, attrs in self.events
            ],
        }

    def __repr__(self):
        tail = self.events[-1][0] if self.events else "?"
        return (f"RequestTrace(rid={self.rid}, events={len(self.events)}, "
                f"last={tail!r})")


class MetricsRegistry:
    """One sink for every publisher; get-or-create metric factories keyed on
    (name, labels). ``enabled=False`` degrades histograms/gauges/traces to
    shared no-op singletons (counters stay real — they back the legacy
    ``engine.stats()`` surface, see module docstring)."""

    def __init__(self, enabled: bool = True, *, trace_capacity: int = 256):
        self.enabled = enabled
        self._metrics: "OrderedDict[tuple, object]" = OrderedDict()
        self._traces: "OrderedDict[int, RequestTrace]" = OrderedDict()
        self.trace_capacity = trace_capacity

    # -- factories -------------------------------------------------------
    def _get(self, cls, name, help, labels, **kw):
        key = (name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
        elif m.kind != cls.kind:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    @staticmethod
    def _labels(labels: dict | None) -> tuple:
        return tuple(sorted((str(k), str(v))
                            for k, v in (labels or {}).items()))

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        # counters are REAL even when disabled (stats() runs on them)
        return self._get(Counter, name, help, self._labels(labels))

    def gauge(self, name: str, help: str = "", labels: dict | None = None,
              fn=None):
        if not self.enabled:
            return _NULL_GAUGE
        g = self._get(Gauge, name, help, self._labels(labels))
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None, *, lo: float = 1e-6,
                  hi: float = 4e3, growth: float = 1.25):
        if not self.enabled:
            return _NULL_HISTOGRAM
        return self._get(Histogram, name, help, self._labels(labels),
                         lo=lo, hi=hi, growth=growth)

    # -- traces ----------------------------------------------------------
    def start_trace(self, rid: int, model_id=None, t: float | None = None):
        if not self.enabled:
            return _NULL_TRACE
        tr = RequestTrace(rid, model_id, t=t)
        self._traces[rid] = tr
        while len(self._traces) > self.trace_capacity:
            self._traces.popitem(last=False)
        return tr

    def trace(self, rid: int):
        """The live/retained trace for ``rid`` (no-op singleton when absent
        or disabled, so call sites never branch)."""
        return self._traces.get(rid, _NULL_TRACE)

    def traces(self) -> list:
        return list(self._traces.values())

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured dict view: {counters, gauges, histograms}, labeled
        series keyed ``name{k="v",...}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (name, labels), m in self._metrics.items():
            key = name + _label_str(labels)
            out[m.kind + "s"][key] = m.snapshot()
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): HELP/TYPE once per
        metric name, then every labeled series; histograms render cumulative
        ``_bucket{le=...}`` + ``_sum`` + ``_count``."""
        by_name: "OrderedDict[str, list]" = OrderedDict()
        for (name, _labels), m in self._metrics.items():
            by_name.setdefault(name, []).append(m)
        lines = []
        for name, ms in by_name.items():
            help_text = next((m.help for m in ms if m.help), "")
            lines.append(f"# HELP {name} {help_text or name}")
            lines.append(f"# TYPE {name} {ms[0].kind}")
            for m in ms:
                ls = _label_str(m.labels)
                if m.kind == "histogram":
                    for ub, cum in m.cumulative_buckets():
                        le = "+Inf" if math.isinf(ub) else repr(ub)
                        sep = "," if m.labels else ""
                        base = ls[:-1] + sep if m.labels else "{"
                        lines.append(
                            f'{name}_bucket{base}le="{le}"}} {cum}')
                    lines.append(f"{name}_sum{ls} {_fmt(m.sum)}")
                    lines.append(f"{name}_count{ls} {m.count}")
                else:
                    lines.append(f"{name}{ls} {_fmt(m.snapshot())}")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------


def lint_prometheus(text: str) -> list[str]:
    """Validate Prometheus text exposition; returns a list of problems
    (empty = clean). Checks the failure modes a scrape actually rejects or
    silently corrupts on: unnamed/garbage sample lines, duplicate series
    (same name + label set twice), samples with no TYPE/HELP header,
    histograms missing the +Inf bucket or with non-monotonic cumulative
    bucket counts, and non-numeric sample values. CI runs the engine's
    render output through this (metrics-smoke job)."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    helped: set[str] = set()
    seen_series: set[str] = set()
    hist_buckets: dict[str, list] = {}

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {ln}: malformed HELP")
            else:
                helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {ln}: malformed TYPE")
            else:
                if parts[2] in typed:
                    problems.append(f"line {ln}: duplicate TYPE for {parts[2]}")
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value
        head, _, val = line.rpartition(" ")
        if not head:
            problems.append(f"line {ln}: unnamed sample {line!r}")
            continue
        try:
            float(val)
        except ValueError:
            problems.append(f"line {ln}: non-numeric value {val!r}")
        series = head.strip()
        name = series.split("{", 1)[0]
        if not name or not name[0].isalpha() and name[0] != "_":
            problems.append(f"line {ln}: unnamed/invalid series {series!r}")
            continue
        if series in seen_series:
            problems.append(f"line {ln}: duplicate series {series!r}")
        seen_series.add(series)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
        if base not in typed:
            problems.append(f"line {ln}: sample {name!r} has no TYPE header")
        if base not in helped:
            problems.append(f"line {ln}: sample {name!r} has no HELP header")
        if name.endswith("_bucket") and typed.get(base) == "histogram":
            lab = series.split("{", 1)[1] if "{" in series else ""
            le = None
            for part in lab.rstrip("}").split(","):
                if part.startswith('le="'):
                    le = part[4:-1]
            key = base + "|" + ",".join(
                p for p in lab.rstrip("}").split(",")
                if not p.startswith('le="'))
            ub = math.inf if le == "+Inf" else float(le)
            hist_buckets.setdefault(key, []).append((ub, float(val), ln))

    for key, buckets in hist_buckets.items():
        buckets.sort(key=lambda b: b[0])
        if not buckets or not math.isinf(buckets[-1][0]):
            problems.append(f"histogram {key.split('|')[0]}: no +Inf bucket")
        last = -1.0
        for ub, cum, ln in buckets:
            if cum < last:
                problems.append(
                    f"line {ln}: histogram {key.split('|')[0]} cumulative "
                    f"bucket counts decrease")
            last = cum
    return problems
