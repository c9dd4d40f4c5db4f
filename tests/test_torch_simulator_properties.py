"""Hypothesis properties of the port's serving simulator:
tests/test_simulator_properties.py's conservation laws on the H100's
figures (``hbm_per_worker`` two H100s where the reference passes two v5e
chips), and bit equality with the reference's simulator, under the
reference's figures, over random workloads and admission policies."""
import pytest

pytest.importorskip("hypothesis", reason="optional dep: property tests only")
import hypothesis.strategies as st
from hypothesis import HealthCheck, given, settings

from repro_torch.configs import get_config
from repro_torch.serving.backpressure import POLICIES
from repro_torch.serving.simulator import ServingConfig, Simulator
from repro_torch.serving.workload import make_sessions
from test_torch_simulator import check_equal, patch_reference_figures

CFG = get_config("internlm2-1.8b")   # small cost model => fast sim
HBM = 2 * 80e9


@settings(max_examples=15, deadline=None)
@given(st.sampled_from(["baseline", "prefillshare"]),
       st.sampled_from(["react", "reflexion"]),
       st.integers(4, 20), st.floats(0.5, 8.0),
       st.sampled_from([8, 32, 128]))
def test_conservation(mode, pattern, n_sessions, rate, max_conc):
    sessions = make_sessions(pattern, n_sessions=n_sessions,
                             arrival_rate=rate, seed=7)
    sim = Simulator(CFG, ServingConfig(mode=mode, max_concurrent=max_conc,
                                       chips_per_worker=2,
                                       hbm_per_worker=HBM), sessions)
    r = sim.run()
    assert r["sessions_done"] == n_sessions
    n_inv = sum(len(s.invocations) for s in sessions)
    assert len(sim.records) == n_inv
    for rec in sim.records:
        assert rec.done >= rec.issued
        assert rec.ttft >= 0
    assert 0.0 <= r["prefix_hit_ratio"] <= 1.0
    assert all(not dw.active for dw in sim.decode)
    assert sim.admitted == 0 and not sim.admission_queue
    for w in sim.prefill:
        w.mgr.pool.check_invariants()
        w.mgr.index.check_invariants()


@settings(max_examples=8, deadline=None)
@given(st.integers(6, 16), st.floats(1.0, 6.0),
       st.floats(0.5, 4.0), st.floats(0.005, 0.1))
def test_model_churn_conserves_work_and_prices_stalls(n_sessions, rate,
                                                      churn_s, rebuild_s):
    runs = {}
    for interval in (0.0, churn_s):
        sessions = make_sessions("react", n_sessions=n_sessions,
                                 arrival_rate=rate, seed=5)
        sim = Simulator(CFG, ServingConfig(
            mode="prefillshare", max_concurrent=64, chips_per_worker=2,
            hbm_per_worker=HBM, churn_interval_s=interval,
            churn_rebuild_s=rebuild_s), sessions)
        runs[interval] = (sim.run(), sim)
    quiet, churned = runs[0.0][0], runs[churn_s][0]
    csim = runs[churn_s][1]
    assert quiet["churn_events"] == 0 and quiet["churn_stall_s"] == 0.0
    assert churned["sessions_done"] == n_sessions
    assert churned["churn_events"] == csim.churn_events > 0
    assert abs(churned["churn_stall_s"]
               - csim.churn_stall_s) < 1e-9
    assert churned["churn_stall_s"] <= (churned["churn_events"]
                                        * rebuild_s * len(csim.decode) + 1e-9)
    assert churned["p95_e2e_s"] >= quiet["p95_e2e_s"] - 1e-6
    assert all(not dw.active for dw in csim.decode)


@settings(max_examples=8, deadline=None)
@given(st.integers(4, 16), st.floats(1.0, 6.0))
def test_prefillshare_never_worse_hit_ratio(n_sessions, rate):
    res = {}
    for mode in ("baseline", "prefillshare"):
        sessions = make_sessions("react", n_sessions=n_sessions,
                                 arrival_rate=rate, seed=11)
        sim = Simulator(CFG, ServingConfig(mode=mode, max_concurrent=64,
                                           chips_per_worker=2,
                                           hbm_per_worker=HBM), sessions)
        res[mode] = sim.run()
    assert (res["prefillshare"]["prefix_hit_ratio"]
            >= res["baseline"]["prefix_hit_ratio"] - 1e-9)


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.sampled_from(["baseline", "prefillshare"]),
       st.sampled_from(["react", "reflexion"]),
       st.integers(4, 20), st.floats(0.5, 8.0),
       st.sampled_from([8, 32, 128]), st.sampled_from(POLICIES))
def test_equal_reference_on_random_workloads(monkeypatch, mode, pattern,
                                             n_sessions, rate, max_conc,
                                             b2_policy):
    """Summary and records equal to the reference's under its figures
    (two v5e chips a worker, as its property tests pass)."""
    patch_reference_figures(monkeypatch)
    kw = dict(mode=mode, max_concurrent=max_conc, chips_per_worker=2,
              hbm_per_worker=32e9, b2_policy=b2_policy)
    want = check_equal("internlm2-1.8b", kw, kw, pattern,
                       n_sessions=n_sessions, arrival_rate=rate, seed=7)
    assert want["sessions_done"] == n_sessions
