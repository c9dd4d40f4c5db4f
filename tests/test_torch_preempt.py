"""The port's priority preemption and host swap tier against the reference.

Mirrors tests/test_preempt.py on the CPU: its toy config (d_model 32, 2
heads of head_dim 16, page 8, 18 pages), the reference's weights carried
across by ``params_from_numpy``, and its contention fleet (two long
low-priority decodes fill the pool, then two high-priority prompts need
pages). A preempted run must give the tokens of the same fleet without
preemption, greedy and seeded, in the port and in the reference; in forced
swap or forced recompute mode the preemption counters must equal the
reference's. Auto mode decides from measured host bandwidth and the cost
model's constants, which differ between the two packages, so there only
the tokens are compared. The reference runs once per module (fixtures).
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving.api import SamplingParams as JaxSamplingParams
from repro.serving.costmodel import CostModel as JaxCostModel
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kvcache.sanitize import SanitizerError
from repro_torch.kvcache.swap import HostSwapPool, _leaves, next_pow2
from repro_torch.params import params_from_numpy
from repro_torch.serving import (CostModel, LocalDisaggEngine,
                                 SamplingParams)
from repro_torch.serving import costmodel as costmodel_module
from repro_torch.serving.metrics import lint_prometheus

KW = dict(name="preempt-eng", arch_type="dense", n_layers=2, d_model=32,
          n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
PAGE = 8
PAGES = 18          # tight: 2 long lo-pri decodes + 2 hi-pri prompts collide
ARMED = dict(preempt=True, overcommit=2.0, sanitize=True)
COUNTERS = ("preemptions", "swap_out_pages", "swap_in_pages",
            "recompute_tokens", "swap_bytes")


@pytest.fixture(scope="module")
def weights():
    jcfg = ModelConfig(**KW)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return (jcfg, jparams), (TModelConfig(**KW), tparams)


def _build(weights, **kw):
    _, (cfg, params) = weights
    kw.setdefault("num_pages", PAGES)
    eng = LocalDisaggEngine(cfg, params, device="cpu", page_size=PAGE,
                            chunked=True, **kw)
    eng.models.register("m", params)     # the base itself: relay-compatible
    return eng


def _fleet(eng, params_cls, seeded):
    sp = dict(temperature=0.8, top_k=8, seed=123) if seeded else {}
    lo = [eng.generate("m", [2 + i] * 9, params_cls(max_tokens=40, **sp),
                       priority=0)
          for i in range(2)]
    for _ in range(4):
        eng.step()
    hi = [eng.generate("m", [30 + i] * 17, params_cls(max_tokens=6, **sp),
                       priority=5)
          for i in range(2)]
    eng.run()
    return [[int(t) for t in h.result()] for h in lo + hi]


def _run_fleet(weights, mode=None, seeded=False, **kw):
    eng = _build(weights, **kw)
    if mode:
        eng.swap.cfg.mode = mode
    return eng, _fleet(eng, SamplingParams, seeded)


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's fleet: tokens without preemption (greedy, seeded)
    and the counters of its forced swap and forced recompute runs."""
    (jcfg, jparams), _ = weights

    def run(mode=None, seeded=False, **kw):
        eng = JaxEngine(jcfg, jparams, paged=True, num_pages=PAGES,
                        page_size=PAGE, chunked=True, **kw)
        eng.models.register("m", jparams)
        if mode:
            eng.swap.cfg.mode = mode
        return eng, _fleet(eng, JaxSamplingParams, seeded)

    out = {"greedy": run()[1], "seeded": run(seeded=True)[1]}
    for mode in ("swap", "recompute"):
        eng, toks = run(mode, **ARMED)
        assert toks == out["greedy"]
        out[mode] = {k: eng.stats()[k] for k in COUNTERS}
    out["page_bytes"] = eng.kvpool.page_bytes
    return out


def _start_decode(eng, tokens=None, max_tokens=12, priority=0):
    h = eng.generate("m", tokens or list(range(1, 12)),
                     SamplingParams(max_tokens=max_tokens), priority=priority)
    for _ in range(32):
        eng.step()
        if eng.scheduler.active:
            return h
    raise AssertionError("request never reached decode")


# ======================================================================
# the swap tier's data plane (kvcache/swap.py)
# ======================================================================

def test_next_pow2():
    assert [next_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


def _rows(kvpool, bids):
    """Copies of the pool rows for ``bids``, every group and tail tensor."""
    st = kvpool.pool_state()
    idx = torch.tensor(list(bids))
    return ([a[:, idx].clone() for key in ("kg", "vg")
             for _, a in sorted(st[key].items())]
            + [a[idx].clone() for key in ("kt", "vt") for a in st[key]])


def test_host_swap_roundtrip_bit_identical(weights, reference):
    """put -> restore into DIFFERENT rows reproduces the pages bit for bit
    across every layer group and tail; sentinel row 0 stays zero; bytes
    and seconds reach ``observe``; page bytes equal the reference's."""
    eng = _build(weights, num_pages=32)
    _start_decode(eng)
    seq = eng.scheduler.active[0]
    assert seq.private_blocks, "fixture must produce private pages"
    bids = list(seq.private_blocks)
    assert eng.kvpool.page_bytes == reference["page_bytes"]
    before = _rows(eng.kvpool, bids)
    seen = []
    host = HostSwapPool(observe=lambda b, s: seen.append((b, s)))
    nbytes = host.put(eng.kvpool, 999, bids)
    assert nbytes == len(bids) * eng.kvpool.page_bytes
    assert 999 in host and host.entry_pages(999) == len(bids)
    assert host.total_bytes == nbytes

    dst = eng.block_pool.alloc(len(bids))
    assert not set(dst) & set(bids)
    host.restore(eng.kvpool, 999, list(range(len(bids))), dst)
    for a, b in zip(before, _rows(eng.kvpool, dst)):
        assert torch.equal(a, b)
    for a in _rows(eng.kvpool, [0]):
        assert not a.any(), "the swap tier wrote sentinel row 0"
    assert [b for b, _ in seen] == [nbytes, nbytes]
    assert all(s > 0 for _, s in seen)
    host.pop(999)
    assert len(host) == 0 and host.total_bytes == 0


def test_host_swap_restores_a_subset_with_pad_slots(weights):
    """Three of four pages restored (a pow2 bucket of 4, one pad slot on
    row 0): each lands bit for bit, row 0 stays zero."""
    eng = _build(weights, num_pages=32)
    src = eng.block_pool.alloc(4)
    g = torch.Generator().manual_seed(0)
    for _, _, a, axis in _leaves(eng.kvpool.pool_state()):
        for b in src:
            a.select(axis, b).copy_(torch.randn(a.select(axis, b).shape,
                                                generator=g))
    before = _rows(eng.kvpool, src)
    host = HostSwapPool()
    host.put(eng.kvpool, 1, src)
    dst = eng.block_pool.alloc(3)
    host.restore(eng.kvpool, 1, [3, 0, 2], dst)
    after = _rows(eng.kvpool, dst)
    for a, b in zip(before, after):
        axis = 1 if a.dim() == 5 else 0
        assert torch.equal(a.index_select(axis, torch.tensor([3, 0, 2])), b)
    for a in _rows(eng.kvpool, [0]):
        assert not a.any()


def test_host_swap_pool_rejects_duplicate_rid(weights):
    eng = _build(weights, num_pages=32)
    _start_decode(eng)
    bids = list(eng.scheduler.active[0].private_blocks)
    host = HostSwapPool()
    host.put(eng.kvpool, 7, bids)
    with pytest.raises(AssertionError, match="already swapped"):
        host.put(eng.kvpool, 7, bids)


def test_pool_state_is_the_pool_itself(weights):
    """``pool_state`` hands out the pool's tensors (no copy), page axis 1
    for group tensors; ``set_pool_state`` adopts a tree's tensors."""
    eng = _build(weights)
    st = eng.kvpool.pool_state()
    for g, a in st["kg"].items():
        assert a is eng.kvpool.k_groups[g]
        assert a.shape[1] == PAGES + 1
    fresh = {k: ({g: t.clone() for g, t in v.items()} if isinstance(v, dict)
                 else [t.clone() for t in v]) for k, v in st.items()}
    eng.kvpool.set_pool_state(fresh)
    for g, a in fresh["vg"].items():
        assert eng.kvpool.v_groups[g] is a


# ======================================================================
# priority plumbing, flags
# ======================================================================

def test_priority_param_validation():
    with pytest.raises(ValueError, match="priority must be an int"):
        SamplingParams(priority="high")
    with pytest.raises(ValueError, match="priority must be an int"):
        SamplingParams(priority=True)
    assert SamplingParams(priority=-3).priority == -3


def test_priority_reaches_decode_seq(weights):
    eng = _build(weights)
    _start_decode(eng, priority=3)
    assert eng.scheduler.active[0].priority == 3
    eng.run()

    eng = _build(weights)
    h = eng.generate("m", list(range(1, 12)),
                     SamplingParams(max_tokens=4, priority=2))
    for _ in range(32):
        eng.step()
        if eng.scheduler.active:
            break
    assert eng.scheduler.active[0].priority == 2
    h.result()

    # eager mode carries it too
    _, (cfg, params) = weights
    eng = LocalDisaggEngine(cfg, params, {"m": params}, device="cpu",
                            num_pages=PAGES, page_size=PAGE)
    eng.generate("m", list(range(1, 12)), SamplingParams(max_tokens=2),
                 priority=4)
    assert eng.scheduler.active[0].priority == 4


def test_engine_flag_validation(weights):
    _, (cfg, params) = weights
    with pytest.raises(ValueError, match="preempt=True requires the paged"):
        LocalDisaggEngine(cfg, params, device="cpu", paged=False,
                          preempt=True)
    with pytest.raises(ValueError, match="only safe with preemption armed"):
        _build(weights, overcommit=2.0)
    with pytest.raises(ValueError, match="overcommit factor must be >= 1"):
        _build(weights, preempt=True, overcommit=0.5)
    assert _build(weights).swap is None


# ======================================================================
# preempted == never preempted == the reference
# ======================================================================

def test_preempt_auto_greedy_matches_reference(weights, reference):
    eng, got = _run_fleet(weights, **ARMED)
    assert got == reference["greedy"]
    assert _run_fleet(weights)[1] == reference["greedy"]
    s = eng.stats()
    assert s["preemptions"] >= 1
    assert eng.block_pool.free_count == PAGES          # baseline restored
    assert s["pages_swapped"] == 0 and s["swapped_seqs"] == 0
    assert set(eng.swap.modes) <= {"swap", "recompute"}


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_forced_mode_matches_reference_with_counters(weights, reference,
                                                     mode):
    eng, got = _run_fleet(weights, mode=mode, **ARMED)
    assert got == reference["greedy"]
    s = eng.stats()
    assert {k: s[k] for k in COUNTERS} == reference[mode]
    assert s["preemptions"] >= 1
    assert eng.swap.modes == [mode] * s["preemptions"]
    if mode == "swap":
        assert s["swap_out_pages"] >= 1
        assert s["swap_bytes"] >= eng.kvpool.page_bytes
    else:
        assert s["recompute_tokens"] >= 1
    assert eng.block_pool.free_count == PAGES
    assert len(eng.swap.host) == 0                     # all entries popped
    assert eng.sanitizer.checks == eng.scheduler.stats.steps


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_seeded_sampling_matches_reference_both_modes(weights, reference,
                                                      mode):
    """Sampling keys fold from (seed, absolute position): parking a victim
    shifts no draw, in either restore path."""
    eng, got = _run_fleet(weights, mode=mode, seeded=True, **ARMED)
    assert got == reference["seeded"]
    assert eng.stats()["preemptions"] >= 1


# ======================================================================
# abort at every lifecycle stage, swapped-out included
# ======================================================================

def _park_one(eng):
    """Drive the fleet until one victim is parked in the swap tier."""
    lo = [eng.generate("m", [2 + i] * 9, SamplingParams(max_tokens=40),
                       priority=0)
          for i in range(2)]
    for _ in range(4):
        eng.step()
    hi = [eng.generate("m", [30 + i] * 17, SamplingParams(max_tokens=6),
                       priority=5)
          for i in range(2)]
    for _ in range(64):
        eng.step()
        if eng.swap.records:
            return lo, hi
    raise AssertionError("no victim was ever parked")


def test_abort_while_swapped_returns_pool_to_baseline(weights):
    eng = _build(weights, **ARMED)
    eng.swap.cfg.mode = "swap"
    lo, hi = _park_one(eng)
    parked_rid = next(iter(eng.swap.records))
    victim = next(h for h in lo if h.request_id == parked_rid)
    assert eng.stats()["swapped_seqs"] == 1
    assert eng.abort(victim)
    assert victim.finished and victim.finish_reason == "abort"
    assert parked_rid not in eng.swap.records
    assert parked_rid not in eng.swap.host
    assert not eng.abort(victim)                        # already aborted
    eng.run()
    for h in lo + hi:
        if h is not victim:
            h.result()
    assert eng.block_pool.free_count == PAGES
    assert eng.block_pool.swapped_count == 0


def test_abort_every_stage_with_preempt_armed(weights):
    eng = _build(weights, **ARMED)
    prompt = list(range(1, 12))
    h = eng.generate("m", prompt, SamplingParams(max_tokens=4))    # queued
    assert eng.abort(h) and h.finish_reason == "abort"
    h = eng.generate("m", prompt, SamplingParams(max_tokens=4))
    eng.step()                                                     # prefill
    assert eng.abort(h) and h.finish_reason == "abort"
    h = _start_decode(eng, max_tokens=8)                           # decode
    assert eng.abort(h) and h.finish_reason == "abort"
    eng.run()
    assert eng.block_pool.free_count == PAGES


def test_parked_model_counts_as_inflight(weights):
    """A parked victim is live work of its model: unregistering it with
    drain waits, and the registry lists its rid."""
    eng = _build(weights, **ARMED)
    eng.swap.cfg.mode = "swap"
    lo, hi = _park_one(eng)
    parked_rid = next(iter(eng.swap.records))
    assert eng._has_inflight("m")
    assert parked_rid in eng._inflight_rids("m")
    eng.run()
    for h in lo + hi:
        h.result()
    assert not eng._has_inflight("m")


# ======================================================================
# storm: refcounts to baseline under sustained churn
# ======================================================================

def _storm(eng):
    rng = np.random.default_rng(0)
    hs = []
    for wave in range(3):
        for i in range(2):
            pr = int(rng.integers(0, 6))
            toks = [int(t) for t in rng.integers(2, 60, size=9)]
            hs.append(eng.generate("m", toks,
                                   SamplingParams(max_tokens=10 + 4 * i),
                                   priority=pr))
        for _ in range(6):
            eng.step()
    eng.run()
    return hs


def test_preempt_storm_sanitized_refcounts_baseline(weights):
    """Mixed-priority storm on a tight pool with the sanitizer checking
    every step: everything finishes with the tokens of an unarmed run,
    nobody thrashes, the pool returns to baseline."""
    eng = _build(weights, **ARMED)
    hs = _storm(eng)
    for h in hs:
        h.result()
        assert h.finish_reason == "length"
    assert eng.block_pool.free_count == PAGES
    assert eng.block_pool.swapped_count == 0
    assert len(eng.swap.host) == 0
    # thrash gate: hysteresis bounds per-sequence park/resume churn
    assert all(n <= 4 for n in eng.swap.resume_counts.values())
    plain = _storm(_build(weights))
    assert [h.tokens for h in hs] == [h.tokens for h in plain]


# ======================================================================
# sanitizer: SWAPPED pages are censused state; the stats surface
# ======================================================================

def test_swapped_page_without_record_names_swap_tier(weights):
    """A page seeded SWAPPED with no owning swap record trips the step
    census with a diagnostic naming the swap tier as the holder class."""
    eng = _build(weights, sanitize=True)
    _start_decode(eng)
    seq = eng.scheduler.active[0]
    assert seq.private_blocks
    eng.block_pool.swap_out([seq.private_blocks[0]])   # no host entry
    with pytest.raises(SanitizerError, match="holder: swap tier"):
        eng.step()


def test_stats_surface_while_parked(weights):
    eng = _build(weights, preempt=True, overcommit=2.0)
    eng.swap.cfg.mode = "swap"
    lo, hi = _park_one(eng)
    s = eng.stats()
    assert s["swapped_seqs"] >= 1
    assert s["pages_swapped"] == eng.block_pool.swapped_count
    assert eng.scheduler.has_work()         # parked victims ARE pending work
    gauges = eng.metrics()["gauges"]
    assert gauges["engine_swapped_sequences"] == s["swapped_seqs"]
    assert gauges["engine_pool_swapped_pages"] == s["pages_swapped"]
    assert gauges["engine_swap_host_bytes"] == eng.swap.host.total_bytes > 0
    assert lint_prometheus(eng.render_prometheus()) == []
    eng.run()
    for h in lo + hi:
        h.result()
    assert eng.block_pool.free_count == PAGES
    counters = eng.metrics()["counters"]
    assert counters["engine_preemptions_total"] == s["preemptions"] >= 1
    assert counters["engine_swap_bytes_total"] == eng.stats()["swap_bytes"]
    assert eng.metrics()["gauges"]["engine_swap_host_bytes"] == 0


# ======================================================================
# the cost model
# ======================================================================

def test_costmodel_names_no_tpu_constant():
    """The port's cost model carries the H100's figures, none of the
    reference's TPU constants."""
    path = Path(costmodel_module.__file__)
    text = path.read_text()
    for word in ("TPU", "v5e", "ICI", "MXU", "197e12", "819e9", "50e9"):
        assert word not in text, word
    names = {t.id for t in ast.walk(ast.parse(text))
             if isinstance(t, ast.Name)}
    assert not names & {"ICI_BW", "MXU_EFF"}
    assert costmodel_module.PEAK_FLOPS == 989e12
    assert costmodel_module.HBM_BW == 3.35e12


def test_costmodel_counts_the_reference_work(weights):
    """Same flops and bytes as the reference for the same step; only the
    hardware figures that turn them into seconds differ."""
    (jcfg, _), (cfg, _) = weights
    ours, ref = CostModel(cfg), JaxCostModel(jcfg)
    for got, want in ((ours.prefill(100, 28), ref.prefill(100, 28)),
                      (ours.decode_step(4, 57.5), ref.decode_step(4, 57.5))):
        assert got.flops == want.flops and got.bytes == want.bytes
        assert got.seconds == max(got.compute_s, got.memory_s) > 0


def test_single_model_fused_step_hands_the_kernel_contiguous_queries(
        weights, monkeypatch):
    """The fleet's one-model fused group with two rows: rope returns q
    head-major, and merging the one-model axis into the rows kept that
    layout as a view, which the card's kernel refuses. Every q it is given
    is contiguous now (the CPU's plain version takes any layout, so the
    check stands in for the card's)."""
    import repro_torch.models.attention as attention
    kernel = attention.paged_decode_attention
    seen = []

    def strict(q, k_pages, v_pages, block_tables, lengths, **kw):
        seen.append(q.shape[0])
        for t in (q, k_pages, v_pages, block_tables, lengths):
            assert t.is_contiguous(), (tuple(t.shape), t.stride())
        return kernel(q, k_pages, v_pages, block_tables, lengths, **kw)

    monkeypatch.setattr(attention, "paged_decode_attention", strict)
    eng = _build(weights)
    hs = [eng.generate("m", [2 + i] * 9, SamplingParams(max_tokens=3))
          for i in range(2)]
    eng.run()
    assert max(seen) == 2 and all(len(h.tokens) == 3 for h in hs)
