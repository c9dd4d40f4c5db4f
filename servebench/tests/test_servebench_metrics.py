"""The metric arithmetic: percentiles over every sample, the tails and the
rate over the whole window, the device's busy union over overlapping
kernels, and the roofline and MFU counts on shapes worked by hand."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import servebench_tiny as tiny
from benchlib import check, cost, devtrace, spec, stats, tails

HP = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
      "head_dim": 2, "d_ff": 16, "vocab_size": 10}
PEAKS = {"bf16_flops_per_s": 100.0, "hbm_bytes_per_s": 10.0}


def _reader(name):
    return spec.metric_reader(tiny.REPO, name)


def test_percentile_is_numpys_linear_over_all_samples():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.exponential(size=n).tolist()
        for q in (50, 95, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12)
    assert stats.percentile([], 95) is None


def _req(submitted, times, failed=False, prompt=4, cached=0):
    return SimpleNamespace(submitted=submitted, times=list(times),
                           first=times[0] if times else None,
                           done=times[-1] if times else submitted + 1.0,
                           failed=failed, call=SimpleNamespace(
                               prompt=[0] * prompt, cached=cached))


def test_tails_count_every_request_and_gap():
    reqs = [_req(0.0, [0.5, 0.6, 0.8]), _req(1.0, [1.1, 1.3]),
            _req(2.0, [], failed=True)]
    ctx = SimpleNamespace(requests=reqs)
    assert tails.ttft_samples(ctx) == pytest.approx([0.5, 0.1, 1.0])
    assert tails.request_samples(ctx) == pytest.approx([0.8, 0.3, 1.0])
    assert tails.itl_samples(ctx) == pytest.approx([0.1, 0.2, 0.2])
    assert _reader("req_p95_s")(ctx) == pytest.approx(
        np.percentile([0.8, 0.3, 1.0], 95))
    assert _reader("itl_p95_s")(ctx) == pytest.approx(
        np.percentile([0.1, 0.2, 0.2], 95))


def test_output_rate_is_every_token_in_the_window_over_its_seconds():
    reqs = [_req(0.0, [0.5, 1.5, 2.5, 9.9, 10.5]), _req(3.0, [4.0, 12.0])]
    ctx = SimpleNamespace(all_reqs=reqs, w0=1.0, w1=11.0, window_s=10.0)
    assert _reader("output_tok_s")(ctx) == pytest.approx(5 / 10.0)


def test_busy_is_the_union_of_overlapping_kernels():
    """Two kernels overlapping by 2 us count 8 us busy, not 10; idle is
    the rest of the annotated stretch, and its gaps are charged to the
    host record running at their midpoint."""
    recs = [(devtrace.WINDOW, False, 0, 100_000),
            ("k1", True, 10_000, 15_000), ("k2", True, 13_000, 18_000),
            ("aten::mm", False, 40_000, 90_000),
            ("k3", True, 50_000, 60_000),
            (devtrace.STEP, True, 0, 100_000)]   # mirrored annotation
    t = devtrace.reduce_records(recs)
    assert t.busy_s == pytest.approx(18_000e-9)
    assert t.longest_gap_s == pytest.approx(40_000e-9)
    assert t.window_s == pytest.approx(100_000e-9)
    gaps = dict(t.idle_gaps)
    assert gaps["short gaps (<20 us)"] == pytest.approx(10_000e-9)
    assert gaps["aten::mm"] == pytest.approx(40_000e-9)
    assert gaps["host (no record)"] == pytest.approx(32_000e-9)
    assert dict(t.ops) == pytest.approx({"k1": 5e-6, "k2": 5e-6, "k3": 1e-5})
    assert t.class_s["other"] == pytest.approx(20_000e-9)
    idle = _reader("device.idle_pct")(SimpleNamespace(trace=t))
    assert idle == pytest.approx(82.0)


def test_a_trace_with_a_gap_longer_than_its_steps_is_not_consistent():
    """Every traced step launches work, so the device cannot idle far
    longer than the longest step: a 1.6 s gap in a stretch of 0.1 s steps
    means the trace lost or misplaced records (as one traced run on the
    card read, with every kernel class at ~45% of its time)."""
    ms = 1_000_000
    recs = [(devtrace.WINDOW, False, 0, 3000 * ms),
            ("k1", True, 10 * ms, 1400 * ms),
            ("k2", True, 3000 * ms - 10, 3000 * ms)]
    t = devtrace.reduce_records(recs)
    assert t.longest_gap_s == pytest.approx(1.6, rel=1e-6)
    assert not devtrace.consistent(t, 0.1)
    assert devtrace.consistent(t, 0.6)
    recs[1] = ("k1", True, 10 * ms, 2900 * ms)
    t = devtrace.reduce_records(recs)
    assert t.longest_gap_s == pytest.approx(0.1, rel=1e-6)
    assert devtrace.consistent(t, 0.1)
    assert not devtrace.consistent(None, 0.1)


def test_decode_work_reads_each_rows_context_once():
    """Rows at positions 11, 13 and 4: K/V tokens 12 + 14 + 5 = 31 per
    layer, each token n_kv_heads * head_dim * (K, V) * 2 B = 16 B; queries
    and outputs 2 * 3 rows * 8 * 2 B; attention 4 * keys * 8 per row."""
    rows = [11, 13, 4]
    flops, nbytes = cost.decode_step_work(HP, rows)
    assert nbytes == 2 * (31 * 16 + 2 * 3 * 8 * 2)
    assert flops == 2 * 4 * (12 + 14 + 5) * 8
    bound = cost.decode_bound_s(HP, [rows, rows], PEAKS)
    assert bound == max(2 * nbytes / 10.0, 2 * flops / 100.0)


def test_prefill_work_is_causal_over_the_cached_prefix():
    """3 new tokens after 5 cached: keys 6 + 7 + 8 = 21; K/V of 8 tokens,
    queries and outputs of 3, in each of the 2 layers; half of a second
    prompt's prefill counts half its work."""
    flops, nbytes = cost.prefill_work(HP, 5, 3)
    assert flops == 2 * 4 * 21 * 8
    assert nbytes == 2 * (8 * 16 + 2 * 3 * 8 * 2)
    assert cost.prefill_bound_s(HP, [(5, 3, 1.0), (0, 3, 0.5)],
                                PEAKS) == max(
        (nbytes + 0.5 * 2 * (3 * 16 + 96)) / 10.0,
        (flops + 0.5 * 2 * 4 * 6 * 8) / 100.0)


def test_a_prefill_is_placed_evenly_over_its_steps():
    """Sent at 0.5, first token pushed at 3.5 inside the step that ends
    at 4: its steps end at 1, 2, 3 and 4, three of them in (1.5, 10]."""
    steps = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert cost.share(steps, 0.5, 3.5, 1.5, 10.0) == 0.75
    assert cost.share(steps, 0.5, 3.5, 0.0, 1.0) == 0.25
    assert cost.share(steps, 0.5, 3.5, 4.0, 9.0) == 0.0
    assert cost.share(steps, 2.0, 2.5, 0.0, 9.0) == 1.0
    reqs = [_req(0.0, [2.5, 3.0], prompt=40, cached=32),
            _req(4.2, [4.8], prompt=8), _req(0.5, [], failed=True)]
    assert cost.prefills_in(reqs, steps, 1.5, 4.5) == [(32, 8, 2 / 3),
                                                        (0, 4, 0.5)]


def test_served_flops_count_what_the_tokens_need():
    """Layer: q,o 8x8 each, k,v 8x4 each, MLP 3 x 8x16 = 576 params. A
    decode token: 2 * (2 * 576 + 10 * 8) = 2464 plus attention in both
    layers; a prefill token: 2 * (576 + 64 (last layer's K,V)) = 1280
    plus attention in the first layer only; a prefill's part counts that
    part of its work."""
    assert cost.decode_token_flops(HP) == 2464
    assert cost.prefill_token_flops(HP) == 1280
    flops = cost.served_flops(HP, [(0, 3, 1.0)], [4])
    assert flops == 3 * 1280 + 2464 + 2 * 4 * 5 * 8 + 1 * 4 * 6 * 8
    assert cost.served_flops(HP, [(0, 3, 0.5)], []) == \
        0.5 * (3 * 1280 + 4 * 6 * 8)


def test_mfu_reads_the_window_without_the_profiler():
    """Two tokens served in the window, one of them while the profiler was
    on (left out with its second); a prefill sent at 0 whose first token
    came in the step ending at 1.6: two of its three steps in the window
    (1, 4]."""
    hp = dict(HP)
    reqs = [_req(0.0, [1.5, 2.5], prompt=4)]
    ctx = SimpleNamespace(all_reqs=reqs, w0=1.0, w1=4.0, window_s=3.0,
                          hp=hp, peaks=PEAKS, profiled=(2.0, 3.0),
                          step_ends=[0.6, 1.2, 1.6, 2.6, 3.6])
    flops = cost.served_flops(hp, [(0, 4, 2 / 3)], [4])
    assert _reader("model.mfu")(ctx) == pytest.approx(
        100.0 * flops / (2.0 * 100.0))
    ctx.profiled = (1.4, 2.0)           # over the prefill's last step
    flops = cost.served_flops(hp, [(0, 4, 1 / 3)], [5])
    assert _reader("model.mfu")(ctx) == pytest.approx(
        100.0 * flops / (2.4 * 100.0))
    ctx.profiled = None
    flops = cost.served_flops(hp, [(0, 4, 2 / 3)], [4, 5])
    assert _reader("model.mfu")(ctx) == pytest.approx(
        100.0 * flops / (3.0 * 100.0))


def test_rooflines_read_nothing_without_device_time():
    t = devtrace.DeviceTrace(window_s=1.0, busy_s=0.5, class_s={})
    ctx = SimpleNamespace(trace=t, peaks=PEAKS, hp=HP, steps_sub=[[]],
                          sub=(0.0, 10.0), step_ends=[1.5, 2.5],
                          all_reqs=[_req(1.0, [2.0], prompt=3)])
    assert _reader("kern.paged_decode_roofline")(ctx) is None
    assert _reader("kern.flash_prefill_paged_roofline")(ctx) is None
    t.class_s = {"paged_decode": 2.0, "flash_prefill_paged": 4.0}
    ctx.steps_sub = [[4]]
    assert _reader("kern.paged_decode_roofline")(ctx) == pytest.approx(
        100.0 * cost.decode_bound_s(HP, ctx.steps_sub, PEAKS) / 2.0)
    assert _reader("kern.flash_prefill_paged_roofline")(ctx) == \
        pytest.approx(100.0 * cost.prefill_bound_s(HP, [(0, 3, 1.0)],
                                                   PEAKS) / 4.0)
    ctx.sub = (3.0, 10.0)               # no prefill in the stretch
    assert _reader("kern.flash_prefill_paged_roofline")(ctx) is None


def test_host_tails_leave_out_the_profiled_stretch():
    """A traced run's host-clock tails drop every request that overlaps
    the profiled stretch (sent before it ends and done after it
    starts)."""
    reqs = [_req(0.0, [0.5, 0.6]), _req(1.0, [3.0, 3.1]),
            _req(4.0, [4.2, 4.9])]
    ctx = SimpleNamespace(requests=reqs, profiled=(2.0, 3.5))
    assert tails.outside_stretch(ctx) == [reqs[0], reqs[2]]
    assert _reader("host.ttft_p95_s")(ctx) == pytest.approx(
        np.percentile([0.5, 0.2], 95))
    assert _reader("host.itl_p95_s")(ctx) == pytest.approx(
        np.percentile([0.1, 0.7], 95))
    ctx.profiled = None
    assert _reader("host.ttft_p95_s")(ctx) == pytest.approx(
        np.percentile([0.5, 2.0, 0.2], 95))


def test_host_rate_leaves_out_the_profiled_stretch():
    """Tokens in the window outside the stretch, over the window's seconds
    less the stretch's: 3 of the 5 tokens in (0, 10], over 10 - 4 s."""
    reqs = [_req(0.0, [1.0, 3.0, 4.0, 6.5, 9.0, 11.0])]
    ctx = SimpleNamespace(all_reqs=reqs, w0=0.0, w1=10.0, window_s=10.0,
                          profiled=(2.0, 6.0))
    assert _reader("host.output_tok_s")(ctx) == pytest.approx(3 / 6.0)


def test_the_sample_holds_the_longest_and_a_share_of_every_decoder():
    def req(model, prompt, served, failed=False):
        return SimpleNamespace(call=SimpleNamespace(model=model,
                                                    prompt=[0] * prompt),
                               tokens=[1] * served, submitted=prompt,
                               done=1.0, failed=failed)
    reqs = [req(m % 4, 10 + i, 5) for i, m in enumerate(range(40))]
    reqs.append(req(2, 500, 5))
    reqs.append(req(1, 900, 5, failed=True))
    picked = check.sample(reqs, 8, 4, seed=2**40 + 1)
    assert picked[0] is reqs[40]
    assert len(picked) == 8
    assert [sum(r.call.model == m for r in picked) for m in range(4)] == \
        [2, 2, 2, 2]
    assert picked == check.sample(reqs, 8, 4, seed=2**40 + 1)


def test_a_request_not_served_in_full_makes_correct_false():
    """Every request of the window has to answer its whole length: one
    that failed, or ended early, fails the run however well the sampled
    tokens score."""
    def req(served, gen=5, failed=False):
        return SimpleNamespace(call=SimpleNamespace(gen=gen),
                               tokens=[1] * served, failed=failed)
    scored = {"max_gap": 0.0, "tokens": 100}
    limits = {"max_gap": 0.1, "min_tokens": 10}
    full = [req(5), req(5)]
    assert check.verdict(scored, limits, full)[0]
    for bad in (req(4), req(5, failed=True), req(6)):
        ok, checks = check.verdict(scored, limits, full + [bad])
        assert not ok
        assert checks["not_served_in_full"] == {"value": 1, "limit": 0}
