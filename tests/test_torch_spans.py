"""The port's span record (``repro_torch.serving.metrics``: ``SPANS``,
``spans()``) and the engine's step and request spans, on a tiny CPU
engine in chunked mode:

- every ``engine.step`` holds its children inside it, in causal order,
  and its attributes count the step's rows, chunks and holds;
- each request's five phases tile its send to its last token exactly, and
  each ``model.chunk`` computes the requests whose ``req.prefill`` covers
  it;
- ``metrics=False`` records nothing and retains nothing per step, with
  the same tokens;
- under a CPU ``torch.profiler`` run the step spans appear as ``cpu_op``
  records (not user annotations) at the ring's times on the real-time
  clock.
"""
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.serving import LocalDisaggEngine, SamplingParams
from repro_torch.serving import metrics as M

CFG = ModelConfig(name="spans-eng", arch_type="dense", n_layers=2,
                  d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                  vocab_size=64, dtype="float32")
#: children of a step, in the order a step runs them
STEP_ORDER = [M.SPAN_REAP, M.SPAN_ADMIT, M.SPAN_PLAN, M.SPAN_CHUNK_FWD,
              M.SPAN_PROMOTE, M.SPAN_DECODE, M.SPAN_PUSH]


@pytest.fixture(scope="module")
def weights():
    return init_params(CFG, 0, device="cpu"), init_params(CFG, 7, device="cpu")


def _engine(weights, **kw):
    base, dec = weights
    return LocalDisaggEngine(CFG, base, {"m0": dec, "m1": base}, device="cpu",
                             num_pages=128, page_size=8, chunked=True,
                             chunk_size=8, token_budget=24, **kw)


def _serve(eng, seed=0, n=5, gen=4):
    """``n`` requests over two decoders, two of them over one context (the
    second is held behind the first, then takes its pages)."""
    rng = np.random.default_rng(seed)
    ctxs = [list(rng.integers(4, 60, size=10 + 6 * i)) for i in range(n - 1)]
    with eng.shared_context() as ctx:
        outs = [eng.generate(f"m{i % 2}", c, SamplingParams(max_tokens=gen))
                for i, c in enumerate(ctxs)]
        outs += [ctx.generate("m0", ctxs[0], SamplingParams(max_tokens=gen)),
                 ctx.generate("m1", ctxs[0], SamplingParams(max_tokens=gen))]
        eng.run()
    return outs


def _new_spans(i0):
    return [s for s in M.spans() if s.index >= i0]


def test_step_children_nest_in_causal_order(weights):
    eng = _engine(weights)
    i0 = M.SPANS._next
    outs = _serve(eng)
    got = _new_spans(i0)
    by_index = {s.index: s for s in got}
    steps = [s for s in got if s.name == M.SPAN_STEP]
    assert [s.key for s in steps] == list(range(1, eng.scheduler.stats.steps
                                                + 1))
    kids = {s.index: [] for s in steps}
    for s in got:
        if s.parent in kids:
            kids[s.parent].append(s)
    rows = grid = tokens = forwards = held = 0
    for st in steps:
        ch = sorted(kids[st.index], key=lambda s: s.start_ns)
        assert [c.name for c in ch] == sorted(
            (c.name for c in ch), key=STEP_ORDER.index)
        for a, b in zip(ch, ch[1:]):
            assert a.end_ns <= b.start_ns
        for c in ch:
            assert st.start_ns <= c.start_ns <= c.end_ns <= st.end_ns
            assert c.key == st.key
        a = st.attrs
        rows, grid = rows + a["decode_rows"], grid + a["grid_rows"]
        tokens += a["chunk_tokens"]
        forwards += a["chunk_forwards"]
        held += a["held"]
        assert a["grid_rows"] >= a["decode_rows"]
        assert a["chunk_forwards"] == sum(c.name == M.SPAN_CHUNK_FWD
                                          for c in ch)
    assert rows == eng.stats.decode_tokens
    assert grid > rows             # two decoders, unequal rows: padding
    assert tokens == eng.scheduler.stats.chunk_tokens
    assert held >= 1
    inner = {M.SPAN_CHUNK_SYNC: M.SPAN_CHUNK_FWD,
             M.SPAN_READBACK: M.SPAN_DECODE,
             M.SPAN_KV_HANDOFF: M.SPAN_PROMOTE}
    for s in got:
        if s.name in inner:
            p = by_index[s.parent]
            assert p.name == inner[s.name]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert sum(s.name == M.SPAN_KV_HANDOFF for s in got) == len(outs)
    assert all(len(o.tokens) == 4 for o in outs)


def test_request_phases_tile_each_request(weights):
    eng = _engine(weights)
    i0 = M.SPANS._next
    outs = _serve(eng, seed=1)
    got = _new_spans(i0)
    reqs = {s.key: s for s in got if s.name == M.SPAN_REQ}
    phases = {}
    for s in got:
        if s.name in M.REQUEST_PHASES:
            assert reqs[s.key].index == s.parent
            phases.setdefault(s.key, []).append(s)
    for out in outs:
        rid = out.request_id
        ps = phases[rid]
        assert [p.name for p in ps] == list(M.REQUEST_PHASES)
        assert ps[0].start_ns == reqs[rid].start_ns == round(
            out.submit_time * 1e9)
        assert ps[-1].end_ns == reqs[rid].end_ns == round(
            out.token_times[-1] * 1e9)
        assert ps[3].end_ns == round(out.token_times[0] * 1e9)
        for a, b in zip(ps, ps[1:]):
            assert a.end_ns == b.start_ns and a.start_ns <= a.end_ns
        a = reqs[rid].attrs
        assert 0 <= a["cached"] <= a["prompt"] and a["finish"] == "length"
        assert reqs[rid].attrs["model"] == out.model_id
    # the held request computes nothing: its prefill is empty, its queue
    # runs to its promotion
    sib = outs[-1].request_id
    assert phases[sib][1].start_ns == phases[sib][1].end_ns
    assert reqs[sib].attrs["cached"] == reqs[sib].attrs["prompt"]
    # a request's prefill runs from the start of the first chunk forward
    # that computes it to the end of the last, inside those forwards' steps
    steps = [s for s in got if s.name == M.SPAN_STEP]

    def step_at(t):
        (st,) = [s for s in steps if s.start_ns <= t <= s.end_ns]
        return st.index
    computes: dict = {}
    for c in (s for s in got if s.name == M.SPAN_CHUNK_FWD):
        for rid in c.attrs["rids"]:
            computes.setdefault(rid, []).append(c)
    assert computes and sib not in computes
    for rid, cs in computes.items():
        p = phases[rid][1]
        assert all(p.start_ns <= c.start_ns and c.end_ns <= p.end_ns
                   for c in cs)
        assert step_at(p.start_ns) == cs[0].parent
        assert step_at(p.end_ns) == cs[-1].parent
        assert p.start_ns <= cs[0].start_ns and cs[-1].end_ns <= p.end_ns


def test_eager_requests_tile_around_their_prefill(weights):
    """Eager mode prefills inside ``generate``: the prefill phase is that
    call's prefill, and the phases still tile the request."""
    base, dec = weights
    eng = LocalDisaggEngine(CFG, base, {"m0": dec}, device="cpu",
                            num_pages=64, page_size=8)
    i0 = M.SPANS._next
    rng = np.random.default_rng(7)
    outs = [eng.generate("m0", list(rng.integers(4, 60, size=20)),
                         SamplingParams(max_tokens=3)) for _ in range(2)]
    eng.run()
    got = _new_spans(i0)
    for out in outs:
        ps = [s for s in got if s.key == out.request_id
              and s.name in M.REQUEST_PHASES]
        assert [p.name for p in ps] == list(M.REQUEST_PHASES)
        assert ps[0].start_ns == round(out.submit_time * 1e9)
        assert ps[-1].end_ns == round(out.token_times[-1] * 1e9)
        assert all(a.end_ns == b.start_ns for a, b in zip(ps, ps[1:]))
        assert ps[1].end_ns > ps[1].start_ns      # it computed its prompt
    M.clear_spans()
    assert M.spans() == []


def test_abort_ends_the_phase_it_interrupts(weights):
    eng = _engine(weights)
    i0 = M.SPANS._next
    rng = np.random.default_rng(2)
    out = eng.generate("m0", list(rng.integers(4, 60, size=40)),
                       SamplingParams(max_tokens=4))
    eng.step()
    assert eng.abort(out)
    got = [s for s in _new_spans(i0) if s.key == out.request_id
           and (s.name == M.SPAN_REQ or s.name in M.REQUEST_PHASES)]
    req, queue, prefill = got
    assert req.attrs["finish"] == "abort"
    assert (queue.name, prefill.name) == M.REQUEST_PHASES[:2]
    assert req.start_ns == queue.start_ns and queue.end_ns == \
        prefill.start_ns and prefill.end_ns == req.end_ns


def _retained_in_metrics_module(fn) -> int:
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        fn()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    return sum(s.size_diff for s in after.compare_to(before, "filename")
               if s.traceback[0].filename == M.__file__)


def test_disabled_records_and_retains_nothing(weights):
    """metrics=False: the engine's spans go to the shared no-op, nothing is
    recorded or kept per step, and the tokens are metrics=True's."""
    streams, retained = [], []
    for metrics in (True, False):
        eng = _engine(weights, metrics=metrics)
        _serve(eng, seed=3)                 # every shape once
        rng = np.random.default_rng(4)
        outs = [eng.generate(f"m{i % 2}", list(rng.integers(4, 60, size=20)),
                             SamplingParams(max_tokens=6)) for i in range(3)]
        i0 = M.SPANS._next
        retained.append(_retained_in_metrics_module(eng.run))
        streams.append([list(o.tokens) for o in outs])
        if not metrics:
            assert eng.spans is M.NULL_SPANS and M.SPANS._next == i0
            assert eng._phases == {}
    assert streams[0] == streams[1]
    assert retained[0] > 0 and retained[1] == 0, retained
    null = M.NULL_SPANS

    def spin():
        for _ in range(1000):
            null.close(null.open(M.SPAN_STEP, 7), None)
            null.add(M.SPAN_REQ, 1, 2, -1, 3, None)
    spin()
    assert _retained_in_metrics_module(spin) == 0


def test_profiler_mirrors_step_spans_as_cpu_ops(weights):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(weights)
    _serve(eng, seed=5)
    rng = np.random.default_rng(6)
    for i in range(3):
        eng.generate(f"m{i % 2}", list(rng.integers(4, 60, size=20)),
                     SamplingParams(max_tokens=3))
    i0 = M.SPANS._next
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        offset = time.time_ns() - time.perf_counter_ns()
        eng.run()
    ring = [s for s in _new_spans(i0) if s.name in STEP_ORDER
            or s.name in (M.SPAN_STEP, M.SPAN_CHUNK_SYNC, M.SPAN_READBACK,
                          M.SPAN_KV_HANDOFF)]
    names = {s.name for s in ring}
    assert {M.SPAN_STEP, M.SPAN_CHUNK_FWD, M.SPAN_DECODE,
            M.SPAN_READBACK} <= names
    recs: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            assert e.device_type() == torch.autograd.DeviceType.CPU
            if hasattr(e, "is_user_annotation"):
                assert not e.is_user_annotation()
            recs.setdefault(e.name(), []).append(e.start_ns())
    for name in names:
        starts = sorted(recs[name])
        mine = [s.start_ns + offset for s in ring if s.name == name]
        assert len(starts) == len(mine), name
        for k, r in zip(starts, sorted(mine)):
            assert abs(k - r) < 100_000, (name, k - r)


def test_profile_launcher_counts_overlapping_kernels_once():
    from repro_torch.launch.profile import _union_ns
    assert _union_ns([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert _union_ns([(3, 4)]) == 1 and _union_ns([]) == 0
