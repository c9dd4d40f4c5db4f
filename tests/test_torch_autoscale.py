"""The port's autoscaler: tests/test_autoscale.py's policy cases on the
copy in ``repro_torch.serving.autoscale`` (decisions equal to the
reference's on every fuzzed signal), and the engine integration on the
CPU: a growing prefill pool changes capacity, never the tokens, which
equal the reference's. The simulator case (tests/test_autoscale.py's) runs
on the H100's figures: one H100 of 80 GB a worker where the reference
passes one v5e chip of 8 GB.
"""
import math

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving import autoscale as jax_autoscale
from repro.serving.api import SamplingParams as JaxSamplingParams
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.params import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving import (AutoscaleConfig, AutoscaleSignals,
                                 Autoscaler, LocalDisaggEngine,
                                 ResizeDecision, SamplingParams,
                                 ServingConfig, Simulator)
from repro_torch.serving.autoscale import decide
from repro_torch.serving.metrics import lint_prometheus
from repro_torch.serving.workload import make_diurnal_sessions


def _sig(rng, cfg):
    n_prefill = int(rng.integers(cfg.min_prefill, cfg.max_prefill + 1))
    n_decode = int(rng.integers(cfg.min_decode, cfg.max_decode + 1))
    if cfg.total_budget is not None:    # a budgeted fleet never starts over
        n_decode = max(cfg.min_decode,
                       min(n_decode, cfg.total_budget - n_prefill))
    return AutoscaleSignals(
        prefill_backlog_tokens=int(rng.integers(0, 20_000)),
        prefill_backlog_s=float(rng.exponential(0.5)),
        decode_occupancy=float(rng.uniform(0, 1.5)),
        free_page_frac=float(rng.uniform(0, 1)),
        ttft_p95_s=(float("nan") if rng.random() < 0.2
                    else float(rng.exponential(0.5))),
        itl_p95_s=(float("nan") if rng.random() < 0.2
                   else float(rng.exponential(0.05))),
        n_prefill=n_prefill,
        n_decode=n_decode,
        inflight_decode=int(rng.integers(0, 2 * n_decode * cfg.decode_slots)))


CONFIGS = [
    AutoscaleConfig(),                                     # cloud-elastic
    AutoscaleConfig(total_budget=8, min_prefill=2, max_prefill=6,
                    min_decode=2, max_decode=6, decode_slots=16),
    AutoscaleConfig(total_budget=4, min_prefill=1, max_prefill=3,
                    min_decode=1, max_decode=3, ttft_target_s=0.2),
]


def _as_reference(obj, cls):
    return cls(**{f: getattr(obj, f) for f in obj.__dataclass_fields__})


@pytest.mark.parametrize("cfg", CONFIGS)
def test_decide_invariants_fuzz(cfg):
    """For any signal sample: at most one worker of movement per pool, the
    [min, max] bands hold, decode never shrinks below in-flight demand, a
    budgeted fleet never exceeds its budget, and the decision is the
    reference's."""
    rng = np.random.default_rng(0)
    jcfg = _as_reference(cfg, jax_autoscale.AutoscaleConfig)
    for _ in range(3000):
        sig = _sig(rng, cfg)
        d = decide(cfg, sig)
        want = jax_autoscale.decide(
            jcfg, _as_reference(sig, jax_autoscale.AutoscaleSignals))
        assert (d.prefill_delta, d.decode_delta, d.reason) == \
            (want.prefill_delta, want.decode_delta, want.reason)
        assert d.prefill_delta in (-1, 0, 1) and d.decode_delta in (-1, 0, 1)
        n_pre = sig.n_prefill + d.prefill_delta
        n_dec = sig.n_decode + d.decode_delta
        assert cfg.min_prefill <= n_pre <= cfg.max_prefill
        assert cfg.min_decode <= n_dec <= cfg.max_decode
        if d.decode_delta < 0:       # never scale below in-flight demand
            assert n_dec * cfg.decode_slots >= sig.inflight_decode
        if cfg.total_budget is not None:
            assert n_pre + n_dec <= cfg.total_budget
            if sig.n_prefill + sig.n_decode == cfg.total_budget:
                assert d.prefill_delta + d.decode_delta == 0


def test_decide_pure_and_deterministic():
    sig = AutoscaleSignals(5000, 2.0, 0.5, 0.5, 0.3, 0.02, 2, 2, 10)
    cfg = AutoscaleConfig()
    assert decide(cfg, sig) == decide(cfg, sig)


def test_converges_under_constant_load():
    """Closed loop against a synthetic plant: from any start the loop
    reaches a fixed point and holds it."""
    cfg = AutoscaleConfig(min_prefill=1, max_prefill=8, min_decode=1,
                          max_decode=8, decode_slots=16)

    def plant(n_pre, n_dec):
        demand = 48
        return AutoscaleSignals(
            prefill_backlog_tokens=4000, prefill_backlog_s=2.4,
            decode_occupancy=demand / (n_dec * cfg.decode_slots),
            free_page_frac=min(1.0, 0.25 * n_dec),
            ttft_p95_s=0.5, itl_p95_s=0.02,
            n_prefill=n_pre, n_decode=n_dec, inflight_decode=demand)

    for start in ((1, 1), (8, 8), (1, 8), (8, 1)):
        n_pre, n_dec = start
        path = [(n_pre, n_dec)]
        for _ in range(64):
            d = decide(cfg, plant(n_pre, n_dec))
            if not d:
                break
            n_pre += d.prefill_delta
            n_dec += d.decode_delta
            path.append((n_pre, n_dec))
        fixed = (n_pre, n_dec)
        for _ in range(10):
            assert not decide(cfg, plant(*fixed)), (start, path)
        sig = plant(*fixed)
        assert sig.prefill_backlog_s / fixed[0] <= cfg.backlog_high_s
        assert sig.decode_occupancy < cfg.occupancy_high


def test_budget_regime_fills_then_shifts():
    cfg = AutoscaleConfig(total_budget=8, min_prefill=1, max_prefill=7,
                          min_decode=1, max_decode=7, decode_slots=16)
    idle = dict(prefill_backlog_tokens=0, prefill_backlog_s=0.0,
                decode_occupancy=0.1, free_page_frac=0.9,
                ttft_p95_s=float("nan"), itl_p95_s=float("nan"),
                inflight_decode=0)
    d = decide(cfg, AutoscaleSignals(n_prefill=2, n_decode=2, **idle))
    assert d and d.prefill_delta + d.decode_delta == 1
    assert not decide(cfg, AutoscaleSignals(n_prefill=4, n_decode=4, **idle))
    pressed = dict(idle, decode_occupancy=0.95, free_page_frac=0.05)
    d = decide(cfg, AutoscaleSignals(n_prefill=4, n_decode=4, **pressed))
    assert (d.prefill_delta, d.decode_delta) == (-1, +1)
    backlogged = dict(idle, prefill_backlog_s=10.0)
    d = decide(cfg, AutoscaleSignals(n_prefill=4, n_decode=4, **backlogged))
    assert (d.prefill_delta, d.decode_delta) == (+1, -1)
    both = dict(pressed, prefill_backlog_s=10.0)
    assert not decide(cfg, AutoscaleSignals(n_prefill=4, n_decode=4, **both))


def test_ttft_attribution_nets_out_decode_itl():
    cfg = AutoscaleConfig(total_budget=8, min_prefill=1, max_prefill=7,
                          min_decode=1, max_decode=7, decode_slots=16,
                          ttft_target_s=0.3)
    sig = AutoscaleSignals(prefill_backlog_tokens=10, prefill_backlog_s=0.01,
                           decode_occupancy=0.95, free_page_frac=0.05,
                           ttft_p95_s=2.0, itl_p95_s=1.9,
                           n_prefill=4, n_decode=4, inflight_decode=40)
    d = decide(cfg, sig)
    assert (d.prefill_delta, d.decode_delta) == (-1, +1)


def test_autoscaler_interval_and_cooldown():
    cfg = AutoscaleConfig(interval_s=1.0, cooldown_intervals=2,
                          shrink_patience=1)
    sc = Autoscaler(cfg)
    grow = AutoscaleSignals(0, 10.0, 0.5, 0.9, float("nan"), float("nan"),
                            1, 1, 0)
    d = sc.tick(grow, now=0.0)
    assert d.prefill_delta == +1 and sc.decisions == [d]
    assert not sc.tick(grow, now=1.0)
    assert not sc.tick(grow, now=2.9)
    assert sc.tick(grow, now=3.0).prefill_delta == +1
    idle = AutoscaleSignals(0, 0.0, 0.5, 0.9, float("nan"), float("nan"),
                            1, 1, 0)
    sc2 = Autoscaler(AutoscaleConfig(interval_s=1.0, shrink_patience=1))
    assert not sc2.tick(idle, now=0.0)
    assert "interval" in sc2.tick(idle, now=0.5).reason
    assert Autoscaler(True).cfg == AutoscaleConfig()


def test_autoscaler_shrink_patience_debounce():
    cfg = AutoscaleConfig(interval_s=1.0, cooldown_intervals=0,
                          shrink_patience=3)
    sc = Autoscaler(cfg)
    idle = AutoscaleSignals(0, 0.0, 0.05, 0.9, float("nan"), float("nan"),
                            4, 1, 0)
    assert "shrink vote" in sc.tick(idle, now=0.0).reason
    assert "shrink vote" in sc.tick(idle, now=1.0).reason
    d = sc.tick(idle, now=2.0)
    assert d.prefill_delta == -1
    sc = Autoscaler(cfg)
    grow = AutoscaleSignals(0, 10.0, 0.5, 0.9, float("nan"), float("nan"),
                            1, 1, 0)
    assert "shrink vote" in sc.tick(idle, now=0.0).reason
    assert sc.tick(grow, now=1.0).prefill_delta == +1
    assert "shrink vote" in sc.tick(idle, now=2.0).reason


def test_resize_decision_bool():
    assert not ResizeDecision()
    assert ResizeDecision(prefill_delta=1)
    assert ResizeDecision(decode_delta=-1)


# ----------------------------------------------------------------------
# simulator integration


#: the prefill-heavy phase's system prompt on the H100's figures (tokens)
INGEST_SYSTEM = 65536


def test_simulator_autoscale_resizes_and_respects_budget():
    """The diurnal scenario drives real resizes; every applied decision
    keeps the fleet exactly at budget, and the split actually moves.
    Raised load: an H100 prefills ~5x faster than a v5e chip (989e12 vs
    197e12 peak) and holds 10x the memory, so with the reference's
    2048-token ingest prompts no worker's backlog reaches
    ``backlog_high_s`` and no decode pool runs short (no resize at all);
    the prefill-heavy half's system prompts become ``INGEST_SYSTEM``."""
    cfg = get_config("internlm2-1.8b")
    ac = AutoscaleConfig(min_prefill=2, max_prefill=6, min_decode=2,
                         max_decode=6, decode_slots=24, total_budget=8,
                         interval_s=0.25, cooldown_intervals=0,
                         backlog_high_s=0.45, backlog_low_s=0.01,
                         free_page_low=0.35)
    sessions = make_diurnal_sessions(n_sessions=24, arrival_rate=5.0,
                                     seed=0, phase_gap_s=8.0)
    for s in sessions[:12]:
        s.system_tokens = INGEST_SYSTEM
    sc = ServingConfig(mode="prefillshare", n_prefill_workers=4,
                       n_decode_workers=4, max_concurrent=96,
                       chips_per_worker=1, hbm_per_worker=80e9,
                       b2_policy="backpressure", prefill_chunk_tokens=256,
                       max_decode_batch=16, autoscale=ac)
    sim = Simulator(cfg, sc, sessions)
    r = sim.run()
    assert r["resize_events"] > 0
    assert (r["final_prefill_workers"] + r["final_decode_workers"]
            == ac.total_budget)
    for d in sim.autoscaler.decisions:
        assert d.prefill_delta + d.decode_delta == 0    # funded shifts only
    assert math.isfinite(r["p95_ttft_s"])


# ----------------------------------------------------------------------
# engine integration

KW = dict(name="autoscale-eng", arch_type="dense", n_layers=2, d_model=32,
          n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
ENGINE = dict(num_pages=256, page_size=8, chunked=True, chunk_size=8,
              token_budget=32)
GROW = AutoscaleConfig(interval_s=0.0, cooldown_intervals=0,
                       backlog_high_s=1e-4, shrink_patience=10_000)


@pytest.fixture(scope="module")
def weights():
    jcfg = ModelConfig(**KW)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdec = jax_init_params(jcfg, jax.random.PRNGKey(7))

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")

    return (jcfg, jbase, jdec), (TModelConfig(**KW), bridge(jbase),
                                 bridge(jdec))


def _contexts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(4, 60, size=48 + i)]
            for i in range(6)]


def _engine(weights, autoscale=None):
    _, (cfg, base, dec) = weights
    eng = LocalDisaggEngine(cfg, base, device="cpu", autoscale=autoscale,
                            **ENGINE)
    eng.models.register("m0", dec)
    return eng


@pytest.fixture(scope="module")
def reference_tokens(weights):
    (jcfg, jbase, jdec), _ = weights
    eng = JaxEngine(jcfg, jbase, **ENGINE)
    eng.models.register("m0", jdec)
    outs = [eng.generate("m0", c, JaxSamplingParams(max_tokens=4))
            for c in _contexts()]
    eng.run()
    return [[int(t) for t in o.tokens] for o in outs]


def test_engine_autoscale_grows_prefill_pool_tokens_unchanged(
        weights, reference_tokens):
    """A long-prompt burst under an aggressive config grows the prefill
    pool mid-run (new workers share the pool, the radix tree and the base
    params), applied moves land on ``engine_autoscale_decisions_total``,
    and the tokens equal a fixed-fleet run's and the reference's."""
    streams = []
    for autoscale in (GROW, None):
        eng = _engine(weights, autoscale)
        outs = [eng.generate("m0", c, SamplingParams(max_tokens=4))
                for c in _contexts()]
        eng.run()
        streams.append([list(o.tokens) for o in outs])
        if autoscale is not None:
            assert len(eng.prefill_workers) > 1        # the pool grew
            assert eng.router.n == len(eng.prefill_workers)
            assert eng._autoscaler.decisions
            assert eng._c_autoscale.value >= 1
            assert eng.metrics()["counters"][
                "engine_autoscale_decisions_total"] == eng._c_autoscale.value
            for w in eng.prefill_workers:              # no weight copy
                assert w.base_params is eng.base_params
                assert w.kvpool is eng.kvpool
                assert w.mgr.index is eng.prefix_index
            assert lint_prometheus(eng.render_prometheus()) == []
    assert streams[0] == streams[1] == reference_tokens


def test_engine_autoscale_signals_and_decode_reserve(weights):
    """The signals read the live engine; a decode_delta moves the extra
    admission reserve by one quantum, capped at half the pool and never
    below zero, and a stalled step gives it back."""
    eng = _engine(weights, AutoscaleConfig(interval_s=0.0))
    eng.generate("m0", _contexts()[0], SamplingParams(max_tokens=2))
    sig = eng._autoscale_signals()
    assert sig.prefill_backlog_tokens == 48 and sig.n_prefill == 1
    assert sig.free_page_frac == 1.0 and sig.inflight_decode == 0
    assert math.isnan(sig.ttft_p95_s)

    class Fixed:
        def __init__(self, d):
            self.d = d

        def tick(self, sig, now):
            return self.d

    eng._autoscaler = Fixed(ResizeDecision(decode_delta=+1))
    for _ in range(40):
        eng._autoscale_tick()
    assert eng.sched_reserve_extra == eng.block_pool.num_blocks // 2
    assert eng.metrics()["gauges"]["engine_sched_reserve_extra_pages"] == \
        eng.sched_reserve_extra
    eng._autoscaler = Fixed(ResizeDecision(decode_delta=-1))
    eng._autoscale_tick()
    assert eng.sched_reserve_extra == (eng.block_pool.num_blocks // 2
                                       - eng._reserve_quantum)
    # the extra reserve is advisory: with all of the pool held back the
    # first step cannot admit, gives it back, and the run completes
    eng._autoscaler = None
    eng.sched_reserve_extra = eng.block_pool.num_blocks
    eng.run()
    assert eng.sched_reserve_extra == 0


def test_engine_remove_prefill_worker_only_when_idle(weights):
    eng = _engine(weights)
    assert not eng._remove_prefill_worker()          # never below one
    eng._add_prefill_worker()
    assert len(eng.prefill_workers) == eng.router.n == 2
    eng.prefill_workers[-1].pending_chunk_tokens = 3
    assert not eng._remove_prefill_worker()          # busy: deferred
    eng.prefill_workers[-1].pending_chunk_tokens = 0
    assert eng._remove_prefill_worker()
    assert len(eng.prefill_workers) == eng.router.n == 1
