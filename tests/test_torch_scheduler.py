"""The port's chunked-prefill scheduler against the reference, on the CPU.

The toy config of tests/test_scheduler.py (d_model 32, 2 heads of head_dim
16, page 8) with the reference's weights carried across by
``params_from_numpy``. The reference engines run once per module (fixtures);
the port runs every scenario of tests/test_scheduler.py and the chunked
abort/SharedContext cases of tests/test_api.py with the kernels' plain
versions. Chunking changes the schedule, never the tokens: the port's
chunked tokens must equal the reference's chunked tokens and the port's own
eager tokens, and its prefill accounting must equal eager's.
"""
import warnings

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kvcache.blocks import PoolExhausted
from repro_torch.params import params_from_numpy
from repro_torch.serving import (FINISH_ABORT, FINISH_LENGTH,
                                 LocalDisaggEngine, SamplingParams)

KW = dict(name="sched-eng", arch_type="dense", n_layers=2, d_model=32,
          n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
PAGE = 8
CHUNKS = (3, 5, 8, 64)


def _ctx(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 60, n)]


def _ctxs(seed, *ns):
    """Contexts drawn one after another from one generator, as the
    reference tests draw them."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(4, 60, size=n)] for n in ns]


def _two_turns():
    """tests/test_scheduler.py::_reference_run's workload: a 19-token
    context, then per model 5 more tokens and 4 generated ones."""
    rng = np.random.default_rng(0)
    ctx = [int(t) for t in rng.integers(4, 60, size=19)]
    return ctx, [[int(t) for t in rng.integers(4, 60, size=5)]
                 for _ in range(2)]


def _ref_invoke(eng, sid, ctx, mid, gen):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return [int(t) for t in eng.invoke(sid, ctx, mid, gen_tokens=gen)]


@pytest.fixture(scope="module")
def weights():
    jcfg = ModelConfig(**KW)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdecs = {f"m{i}": jax_init_params(jcfg, jax.random.PRNGKey(10 + i))
             for i in range(2)}

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")

    return ((jcfg, jbase, jdecs),
            (TModelConfig(**KW), bridge(jbase),
             {m: bridge(p) for m, p in jdecs.items()}))


@pytest.fixture(scope="module")
def ref_chunked(weights):
    """The reference's chunked engine over the two-turn workload, per chunk
    size: (tokens, prefill tokens computed, reused)."""
    (jcfg, jbase, jdecs), _ = weights
    runs = {}
    for chunk in CHUNKS:
        eng = JaxEngine(jcfg, jbase, jdecs, num_pages=64, page_size=PAGE,
                        chunked=True, chunk_size=chunk, token_budget=16)
        ctx, adds = _two_turns()
        outs = []
        for mid, add in zip(("m0", "m1"), adds):
            ctx = ctx + add
            outs.append(_ref_invoke(eng, 0, ctx, mid, 4))
            ctx = ctx + outs[-1]
        runs[chunk] = (outs, eng.stats.prefill_tokens_computed,
                       eng.stats.prefill_tokens_reused)
    return runs


@pytest.fixture(scope="module")
def ref_tokens(weights):
    """The reference (eager) engine's tokens for every other scenario's
    jobs, one session per job: {name: [tokens per job]}."""
    (jcfg, jbase, jdecs), _ = weights
    eng = JaxEngine(jcfg, jbase, jdecs, num_pages=256, page_size=PAGE)
    sid = iter(range(1000))
    return {name: [_ref_invoke(eng, next(sid), ctx, mid, gen)
                   for ctx, mid, gen in jobs]
            for name, jobs in SCENARIOS.items()}


SCENARIOS = {
    "mid_page": [(_ctx(3, 19), "m0", 5)],
    "full_hit": [(_ctx(4, 2 * PAGE), "m0", 4), (_ctx(4, 2 * PAGE), "m1", 4)],
    "sibling": [(_ctx(5, 20), "m0", 3), (_ctx(5, 20), "m1", 3)],
    "pinned": [(_ctx(10, 2 * PAGE), "m1", 3)],
    "backpressure": [(c, m, 10) for c, m in zip(_ctxs(7, 18, 18),
                                                 ("m0", "m1"))],
    "batched": [(c, "m0", 3) for c in _ctxs(9, 24, 24, 24)],
    "tails": [(_ctx(16, 3 * PAGE) + _ctx(17, 5), "m0", 3),
              (_ctx(16, 3 * PAGE) + _ctx(18, 7), "m1", 3)],
}


def _engine(weights, **kw):
    _, (tcfg, base, decs) = weights
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    return LocalDisaggEngine(tcfg, base, decs, device="cpu", **kw)


def _chunked(weights, chunk, budget, **kw):
    return _engine(weights, chunked=True, chunk_size=chunk,
                   token_budget=budget, **kw)


def _run(eng, sid, ctx, mid, gen):
    return eng.generate(mid, ctx, SamplingParams(max_tokens=gen),
                        session=sid).result().tolist()


# ======================================================================
# tokens: chunked == reference chunked == eager


@pytest.fixture(scope="module")
def port_eager(weights):
    eng = _engine(weights)
    ctx, adds = _two_turns()
    outs = []
    for mid, add in zip(("m0", "m1"), adds):
        ctx = ctx + add
        outs.append(_run(eng, 0, ctx, mid, 4))
        ctx = ctx + outs[-1]
    return outs, eng.stats.prefill_tokens_computed, \
        eng.stats.prefill_tokens_reused


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_matches_reference_and_eager(weights, ref_chunked, port_eager,
                                             chunk):
    """Greedy tokens equal the reference's chunked engine and the port's
    eager engine for every chunk size, including chunk >= prompt (today's
    whole-tail prefill); the prefill computed/reused counts equal eager's
    and the reference's."""
    eng = _chunked(weights, chunk, 16)
    ctx, adds = _two_turns()
    got = []
    for mid, add in zip(("m0", "m1"), adds):
        ctx = ctx + add
        got.append(_run(eng, 0, ctx, mid, 4))
        ctx = ctx + got[-1]
    want, computed, reused = ref_chunked[chunk]
    assert got == want == port_eager[0]
    assert (eng.stats.prefill_tokens_computed,
            eng.stats.prefill_tokens_reused) == (computed, reused) \
        == port_eager[1:]
    if chunk < 19:
        assert eng.scheduler.stats.chunks > 1
    eng.end_session(0)
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0


def test_chunk_boundary_mid_page(weights, ref_tokens):
    """6-token chunks over page 8: boundaries at 6, 12, 18 land mid-page and
    the next chunk appends into the same physical page."""
    (ctx, mid, gen), = SCENARIOS["mid_page"]
    eng = _chunked(weights, 6, 32)
    assert _run(eng, 0, ctx, mid, gen) == ref_tokens["mid_page"][0]
    assert eng.scheduler.stats.chunks == 4             # 6 + 6 + 6 + 1
    assert len(eng.prefill_workers[0].sessions[0].block_table) == 3
    eng.end_session(0)
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0


def test_zero_length_tail_after_full_prefix_hit(weights, ref_tokens):
    """A page-aligned prompt fully covered by cached pages needs ZERO
    chunks: admission goes straight to the decode handoff."""
    eng = _chunked(weights, 4, 32)
    (c0, m0, g0), (c1, m1, g1) = SCENARIOS["full_hit"]
    assert _run(eng, 0, c0, m0, g0) == ref_tokens["full_hit"][0]
    computed = eng.stats.prefill_tokens_computed
    chunks = eng.scheduler.stats.chunks
    assert _run(eng, 1, c1, m1, g1) == ref_tokens["full_hit"][1]
    assert eng.stats.prefill_tokens_computed == computed
    assert eng.scheduler.stats.chunks == chunks
    assert eng.stats.prefill_tokens_reused >= 2 * PAGE
    eng.end_session(0)
    eng.end_session(1)
    eng.block_pool.check_invariants()


# ======================================================================
# admission: siblings, backpressure, exhaustion, priority, batching


def test_sibling_fast_path_computes_once(weights, ref_tokens):
    """Two decode models over one identical context: the second request is
    held until the first commits, then served from the session's pages."""
    eng = _chunked(weights, 8, 32)
    outs = [eng.generate(mid, ctx, SamplingParams(max_tokens=gen), session=0)
            for ctx, mid, gen in SCENARIOS["sibling"]]
    eng.run()
    assert [o.tokens for o in outs] == ref_tokens["sibling"]
    assert eng.stats.prefill_tokens_computed == 20        # computed ONCE
    assert eng.stats.prefill_tokens_reused == 20          # sibling reuse
    assert eng.stats.cow_page_copies == 2                 # one clone each
    eng.end_session(0)
    eng.block_pool.check_invariants()


def test_sibling_pin_survives_leader_session_end(weights, ref_tokens):
    """The sibling fast path pins the leader session's pages at admission,
    so they stay active if the leader session ends before promotion."""
    (ctx, mid, gen), = SCENARIOS["pinned"]
    eng = _chunked(weights, 8, 32)
    _run(eng, 0, ctx, "m0", 3)                     # leader session resident
    out = eng.generate(mid, ctx, SamplingParams(max_tokens=gen), session=0)
    eng.scheduler._admit()                         # sibling captured, pinned
    eng.end_session(0)                             # leader lets go
    for p in eng.scheduler.prefilling[0].sibling_bt:
        assert eng.block_pool.refcount(p) >= 1
    eng.run()
    assert out.tokens == ref_tokens["pinned"][0]
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0


def test_hard_pool_exhaustion_raises(weights):
    """A prompt the pool can never host fails loudly, not by spinning."""
    eng = _chunked(weights, 4, 32, num_pages=2)
    eng.generate("m0", _ctx(6, 40), SamplingParams(max_tokens=2), session=0)
    with pytest.raises(PoolExhausted, match="stalled"):
        eng.run()


def test_backpressure_holds_request_until_decode_frees_pages(weights,
                                                              ref_tokens):
    """A request whose chunk cannot obtain pages is HELD (its computed
    pages stay put) and completes once the running decode frees pages."""
    eng = _chunked(weights, 6, 8, num_pages=9)
    outs = [eng.generate(mid, ctx, SamplingParams(max_tokens=gen),
                         session=sid)
            for sid, (ctx, mid, gen) in enumerate(SCENARIOS["backpressure"])]
    eng.run()
    assert [o.tokens for o in outs] == ref_tokens["backpressure"]
    assert eng.scheduler.stats.stalls > 0
    eng.end_session(0)
    eng.end_session(1)
    eng.block_pool.check_invariants()


def test_priority_policy_schedules_high_priority_first(weights):
    """Under the priority policy a late high-priority request finishes
    prefill before an earlier low-priority long prompt; fcfs keeps arrival
    order."""
    order = {}
    for policy in ("priority", "fcfs"):
        eng = _chunked(weights, 8, 8, sched_policy=policy)
        low = eng.generate("m0", _ctx(8, 48), SamplingParams(max_tokens=2),
                           session=0)
        high = eng.generate("m1", _ctx(9, 16),
                            SamplingParams(max_tokens=2, priority=5),
                            session=1)
        eng.run()
        p = eng.scheduler.promoted
        order[policy] = p.index(high.request_id) < p.index(low.request_id)
    assert order == {"priority": True, "fcfs": False}


def test_equal_length_chunks_batch_into_one_forward(weights, ref_tokens):
    eng = _chunked(weights, 8, 64)
    outs = [eng.generate(mid, ctx, SamplingParams(max_tokens=gen),
                         session=sid)
            for sid, (ctx, mid, gen) in enumerate(SCENARIOS["batched"])]
    eng.run()
    assert [o.tokens for o in outs] == ref_tokens["batched"]
    assert eng.scheduler.stats.max_prefill_batch >= 2
    assert eng.scheduler.stats.chunks == 9        # 3 requests x 3 chunks


def test_chunk_backlog_routes_across_two_prefill_workers(weights,
                                                         ref_tokens):
    """With two prefill workers, admission routes by the issued work plus
    each worker's admitted-but-uncomputed chunk tokens; the backlog drains
    to zero and the tokens are the reference's."""
    eng = _chunked(weights, 8, 64, n_prefill_workers=2,
                   router_policy="least_loaded")
    outs = [eng.generate(mid, ctx, SamplingParams(max_tokens=gen),
                         session=sid)
            for sid, (ctx, mid, gen) in enumerate(SCENARIOS["batched"])]
    eng.step()                               # admitted, first chunks run
    assert sum(w.pending_chunk_tokens for w in eng.prefill_workers) > 0
    eng.run()
    assert [o.tokens for o in outs] == ref_tokens["batched"]
    assert all(w.pending_chunk_tokens == 0 for w in eng.prefill_workers)
    eng.block_pool.check_invariants()


def test_unregister_aborts_queued_requests(weights):
    """Registry churn sees queued and prefilling work too: a queued
    request of an unregistered model is aborted and pages stay at
    baseline."""
    eng = _chunked(weights, 5, 16)
    free0 = eng.block_pool.free_count
    out = eng.generate("m1", _ctx(30, 21), SamplingParams(max_tokens=3))
    assert eng._has_inflight("m1")
    assert eng.models.unregister("m1", drain=False)
    assert out.finish_reason == FINISH_ABORT
    assert not eng.scheduler.has_work()
    eng.models.sync()
    assert eng.block_pool.free_count == free0


# ======================================================================
# abort at every stage (tests/test_api.py) and SharedContext


def _baseline(eng):
    eng.block_pool.check_invariants()
    return eng.block_pool.free_count


def test_abort_queued_request(weights):
    eng = _chunked(weights, 5, 16)
    base = _baseline(eng)
    out = eng.generate("m0", _ctx(9, 19), SamplingParams(max_tokens=4))
    assert eng.abort(out) is True
    assert out.finished and out.finish_reason == FINISH_ABORT
    assert not eng.scheduler.has_work()
    assert eng.block_pool.free_count == base
    assert eng.abort(out) is False                 # idempotent


def test_abort_mid_chunk_prefill(weights):
    """Computed tail pages are dropped, cached-prefix refs return; the
    survivor's tokens are unharmed."""
    eng = _chunked(weights, 5, 8)
    base = _baseline(eng)
    victim = eng.generate("m0", _ctx(10, 40), SamplingParams(max_tokens=4))
    other = eng.generate("m1", _ctx(11, 19), SamplingParams(max_tokens=4))
    eng.step()
    eng.step()
    assert any(r.rid == victim.request_id and 0 < r.done < r.n
               for r in eng.scheduler.prefilling)
    assert victim.abort() is True
    want = _run(_engine(weights), None, _ctx(11, 19), "m1", 4)
    assert other.result().tolist() == want
    assert eng.block_pool.free_count == base
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0


def test_abort_held_under_pool_exhaustion(weights):
    eng = _chunked(weights, 6, 8, num_pages=9)
    base = _baseline(eng)
    ra = eng.generate("m0", _ctx(12, 18), SamplingParams(max_tokens=10))
    rb = eng.generate("m1", _ctx(13, 18), SamplingParams(max_tokens=10))
    held = False
    for _ in range(40):
        eng.step()
        if eng.scheduler.stats.stalls and any(
                r.rid == rb.request_id for r in eng.scheduler.prefilling):
            held = True
            break
    assert held, "workload never hit backpressure"
    assert rb.abort() is True
    eng.run()
    assert ra.finished and ra.finish_reason == FINISH_LENGTH
    assert eng.block_pool.free_count == base
    eng.block_pool.check_invariants()


def test_abort_decoding_and_cached_prefix_return_baseline(weights):
    """Abort mid-chunk over a cached prefix, and while decoding: the free
    count returns to the post-warm baseline and the prefix still hits."""
    eng = _chunked(weights, 5, 16)
    prefix = _ctx(40, 4 * PAGE)
    eng.generate("m0", prefix, SamplingParams(max_tokens=2)).result()
    base = _baseline(eng)
    victim = eng.generate("m0", prefix + _ctx(41, 12),
                          SamplingParams(max_tokens=4))
    eng.step()
    r = next(r for r in eng.scheduler.prefilling
             if r.rid == victim.request_id)
    assert r.alloc.cached_tokens == 4 * PAGE
    assert victim.abort() is True
    assert eng.block_pool.free_count == base
    out = eng.generate("m0", prefix + _ctx(42, 5),
                       SamplingParams(max_tokens=12))
    while not out.tokens:
        eng.step()
    partial = list(out.tokens)
    assert out.abort() is True
    assert out.tokens == partial                   # stream frozen
    eng.run()
    assert eng.block_pool.free_count == base
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0
    eng.generate("m0", prefix + _ctx(43, 7), SamplingParams(max_tokens=3)) \
        .result()
    assert eng.stats()["prefix_hit_tokens"] >= 3 * 4 * PAGE
    assert eng.block_pool.free_count == base


def test_shared_context_chunked_with_tails(weights, ref_tokens):
    """SharedContext on the chunked scheduler: the prefix is prefilled by a
    prefill-only request, the tails stay private, tokens match."""
    eng = _chunked(weights, 6, 16, num_pages=128)
    prefix = _ctx(16, 3 * PAGE)
    with eng.shared_context(prefix) as ctx:
        assert eng.scheduler.stats.chunks == 4      # 24 tokens in 6s
        outs = [ctx.generate(mid, c[len(prefix):],
                             SamplingParams(max_tokens=gen))
                for c, mid, gen in SCENARIOS["tails"]]
        eng.run()
        assert [o.tokens for o in outs] == ref_tokens["tails"]
        assert ctx.tokens == prefix                # tails stayed private
    assert eng.stats.prefill_tokens_reused >= 2 * len(prefix)
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0
