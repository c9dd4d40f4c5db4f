"""The port's serving simulator against the reference's, bit for bit.

With the reference's hardware figures patched into the port for the test
only (the roofline's peaks and efficiencies, the 50 GB/s handoff link and
the reference's four links, its swap link and churn stall, and the worker
memory the reference's own tests pass), ``Simulator(...).run()`` returns
the reference's summary (NaN-aware exact equality) and the same invocation
records, field by field, on the same sessions. Each case also asserts, on
the reference's run, that the feature it covers did something (a staged
handoff, a preemption, a resize, an early stop), so equality is never
between two idle runs. The port's own figures are the H100's:
tests/test_torch_serving.py holds them to the reference's assertions.
"""
import dataclasses
import functools
import math

import pytest

from repro.configs import get_config as jget
from repro.kvcache.blocks import PoolExhausted as JPoolExhausted
from repro.serving import simulator as JS
from repro.serving import workload as JW
from repro.serving.autoscale import AutoscaleConfig as JAutoscaleConfig
from repro.serving.backpressure import POLICIES as JB2
from repro.serving.router import POLICIES as JROUTER
from repro_torch.configs import get_config as tget
from repro_torch.kvcache.blocks import PoolExhausted
from repro_torch.kvcache.handoff import HandoffChannel
from repro_torch.serving import costmodel as TC
from repro_torch.serving import simulator as TS
from repro_torch.serving import workload as TW
from repro_torch.serving.autoscale import AutoscaleConfig
from repro_torch.serving.backpressure import POLICIES
from repro_torch.serving.router import POLICIES as ROUTER_POLICIES

#: the reference's cost-model figures (``repro.serving.costmodel``)
REF_COST = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "MATMUL_EFF": 0.55,
            "BW_EFF": 0.80}
#: the reference's ``ServingConfig`` defaults that the port sets from the
#: H100 (handoff links, swap link GB/s, churn stall s)
REF_SCFG = {"handoff_links": 4, "swap_gbps": 10.0, "churn_rebuild_s": 0.02}
REF_LINK_GBPS = 50.0


def patch_reference_figures(monkeypatch):
    """Put the reference's figures into the port's cost model and handoff
    link (``ServingConfig`` fields are passed per run, see ``port_run``)."""
    for k, v in REF_COST.items():
        monkeypatch.setattr(TC, k, v)
    monkeypatch.setattr(TS, "HandoffChannel",
                        functools.partial(HandoffChannel,
                                          link_gbps=REF_LINK_GBPS))


@pytest.fixture
def ref_figures(monkeypatch):
    patch_reference_figures(monkeypatch)


def same(a, b) -> bool:
    """Exact equality, NaN equal to NaN, through dicts and sequences."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def sessions(pattern, *, diurnal=False, **kw):
    """The same sessions from each package's generator; asserts they
    agree field by field."""
    if diurnal:
        j, t = (JW.make_diurnal_sessions(**kw),
                TW.make_diurnal_sessions(**kw))
    else:
        j, t = JW.make_sessions(pattern, **kw), TW.make_sessions(pattern, **kw)
    assert [dataclasses.asdict(s) for s in j] == \
        [dataclasses.asdict(s) for s in t]
    return j, t


def _records(sim) -> list:
    return [dataclasses.astuple(r) for r in sim.records]


def ref_run(arch, scfg: dict, sess):
    sim = JS.Simulator(jget(arch), JS.ServingConfig(**scfg), sess)
    return sim.run(), sim


def port_run(arch, scfg: dict, sess):
    sim = TS.Simulator(tget(arch), TS.ServingConfig(**{**REF_SCFG, **scfg}),
                       sess)
    return sim.run(), sim


def check_equal(arch, scfg: dict, ref_scfg: dict, pattern="react",
                diurnal=False, **skw):
    """Run both on the same sessions; return the reference's summary."""
    js, ts = sessions(pattern, diurnal=diurnal, **skw)
    want, jsim = ref_run(arch, ref_scfg, js)
    got, tsim = port_run(arch, scfg, ts)
    assert same(got, want), (got, want)
    assert same(_records(tsim), _records(jsim))
    assert tsim.t_end == jsim.t_end
    return want


BASE = dict(chips_per_worker=2, hbm_per_worker=32e9)


@pytest.mark.parametrize("mode", ["baseline", "prefillshare"])
@pytest.mark.parametrize("pattern", sorted(TW.PATTERNS))
def test_modes_and_patterns_equal_reference(ref_figures, mode, pattern):
    assert sorted(TW.PATTERNS) == sorted(JW.PATTERNS)
    kw = dict(BASE, mode=mode, hbm_per_worker=24e9)
    want = check_equal("llama31-8b", kw, kw, pattern, n_sessions=16,
                       arrival_rate=4.0, seed=3)
    assert want["sessions_done"] == 16
    if mode == "baseline":
        assert want["evictions"] > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_b2_policies_equal_reference(ref_figures, policy):
    assert POLICIES == JB2
    kw = dict(mode="prefillshare", chips_per_worker=2, hbm_per_worker=20e9,
              max_concurrent=160, b2_policy=policy)
    want = check_equal("llama31-8b", kw, kw, n_sessions=24,
                       arrival_rate=6.0, seed=3)
    if policy == "staging":
        assert want["staged_frac"] > 0


@pytest.mark.parametrize("policy", ROUTER_POLICIES)
def test_router_policies_equal_reference(ref_figures, policy):
    assert ROUTER_POLICIES == JROUTER
    kw = dict(BASE, mode="prefillshare", max_concurrent=128,
              router_policy=policy)
    check_equal("llama31-8b", kw, kw, n_sessions=24, arrival_rate=8.0,
                seed=5)


FEATURES = {
    "chunked": (dict(prefill_chunk_tokens=256), "prefill_busy_frac"),
    "eos": (dict(eos_prob=0.02), "early_stop_frac"),
    "churn": (dict(churn_interval_s=1.0), "churn_stall_s"),
    "churn_rebuild": (dict(churn_interval_s=0.5, churn_rebuild_s=0.05),
                      "churn_events"),
    "autoscale": (dict(autoscale=True, n_prefill_workers=2,
                       n_decode_workers=2), "final_prefill_workers"),
    "overcommit": (dict(overcommit=2.0, hbm_per_worker=18e9,
                        max_concurrent=8), "preemptions"),
    "overcommit_swap": (dict(overcommit=2.0, hbm_per_worker=18e9,
                             max_concurrent=8, swap_gbps=2.5),
                        "swap_stall_s"),
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_features_equal_reference(ref_figures, feature):
    extra, key = FEATURES[feature]
    kw = dict(BASE, mode="prefillshare", **extra)
    want = check_equal("llama31-8b", kw, kw, n_sessions=16,
                       arrival_rate=4.0, seed=3)
    assert want["sessions_done"] == 16
    assert want[key] > 0, (key, want)


def test_autoscale_config_and_diurnal_sessions_equal_reference(ref_figures):
    """tests/test_autoscale.py's simulator case (1 chip, 8e9 a worker)."""
    fields = dict(min_prefill=2, max_prefill=6, min_decode=2, max_decode=6,
                  decode_slots=24, total_budget=8, interval_s=0.25,
                  cooldown_intervals=0, backlog_high_s=0.45,
                  backlog_low_s=0.01, free_page_low=0.35)
    base = dict(mode="prefillshare", n_prefill_workers=4, n_decode_workers=4,
                max_concurrent=96, chips_per_worker=1, hbm_per_worker=8e9,
                b2_policy="backpressure", prefill_chunk_tokens=256,
                max_decode_batch=16)
    want = check_equal("internlm2-1.8b",
                       dict(base, autoscale=AutoscaleConfig(**fields)),
                       dict(base, autoscale=JAutoscaleConfig(**fields)),
                       diurnal=True, n_sessions=24, arrival_rate=5.0, seed=0,
                       phase_gap_s=8.0)
    assert want["resize_events"] > 0


def test_stalled_chunked_prefill_raises_and_returns_its_pages(ref_figures):
    """A prompt longer than a worker's whole pool (64 pages of 16 tokens)
    can never finish its chunks: both simulators fail loudly; the port
    hands the partial allocation back first, where the reference leaves
    its pages active."""
    js, ts = sessions("react", n_sessions=1, arrival_rate=1.0, seed=0)
    for s in js + ts:
        s.system_tokens = 2048
    kw = dict(mode="prefillshare", chips_per_worker=1, n_prefill_workers=1,
              hbm_per_worker=tget("llama31-8b").param_count() * 2 + 1,
              prefill_chunk_tokens=256)
    jsim = JS.Simulator(jget("llama31-8b"), JS.ServingConfig(**kw), js)
    tsim = TS.Simulator(tget("llama31-8b"),
                        TS.ServingConfig(**{**REF_SCFG, **kw}), ts)
    for sim, exc in ((jsim, JPoolExhausted), (tsim, PoolExhausted)):
        with pytest.raises(exc, match="none can grow"):
            sim.run()
    assert jsim.prefill[0].mgr.pool.active_count > 0
    pool = tsim.prefill[0].mgr.pool
    assert pool.num_blocks == 64 and pool.active_count == 0
    pool.check_invariants()
    tsim.prefill[0].mgr.index.check_invariants()


def test_defaults_are_the_h100s():
    """The port's own figures: no TPU figure is left in its defaults."""
    scfg = TS.ServingConfig()
    assert scfg.hbm_per_worker == scfg.chips_per_worker * 80e9
    assert scfg.handoff_links == 18 and scfg.swap_gbps == 11.3
    assert scfg.churn_rebuild_s == TS.CHURN_REBUILD_S < REF_SCFG[
        "churn_rebuild_s"]
    ch = HandoffChannel(tget("llama31-8b"), n_links=scfg.handoff_links)
    assert ch.bw == 18 * 25e9
    assert (TC.PEAK_FLOPS, TC.HBM_BW, TC.HBM_BYTES) == (989e12, 3.35e12, 80e9)
