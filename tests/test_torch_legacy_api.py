"""The port's request-id surface against the reference's, on carried-across
weights (tests/test_api.py::test_legacy_surface_warns_and_stays_token_identical
and tests/test_fused_decode.py::test_result_fetch_states, on the CPU):

- ``submit`` + ``run`` + ``result`` tokens equal the reference's and the
  port's own ``generate(...).result()``, eager and chunked, and ``submit``
  and ``invoke`` warn as the reference does;
- the four fetch-state ``KeyError`` texts (pending, already fetched,
  aborted, unknown) equal the reference's word for word, an aborted
  submission included;
- ``invoke`` on the paged plane and on the dense fallback (mamba2-780m,
  reduced, tests/test_engine_ssm.py's session) equals the reference's;
- ``HostSwapPool.bids`` after a forced swap names the swapped pages, the
  same pages the reference's pool names at the same step;
- a shared context's warm-up takes a request id and leaves no result
  behind, eager and chunked, as in the reference.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.params import params_from_numpy
from repro_torch.serving import LocalDisaggEngine, SamplingParams

KW = dict(name="legacy-eng", arch_type="dense", n_layers=2, d_model=32,
          n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
PAGE = 8
MODES = {"eager": {},
         "chunked": dict(chunked=True, chunk_size=5, token_budget=16)}
GEN = 5


def _bridge(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _tok(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 60, n)]


CTX = _tok(0, 19)                        # off a page boundary
TAILS = {"m0": _tok(1, 6), "m1": _tok(2, 9)}


@pytest.fixture(scope="module")
def weights():
    jcfg = ModelConfig(**KW)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdecs = {m: jax_init_params(jcfg, jax.random.PRNGKey(10 + i))
             for i, m in enumerate(TAILS)}
    return (jcfg, jbase, jdecs), (TModelConfig(**KW), _bridge(jbase),
                                  {m: _bridge(p) for m, p in jdecs.items()})


def _engine(cls, cfg, base, decs, mode, **kw):
    if cls is LocalDisaggEngine:
        kw["device"] = "cpu"
    return cls(cfg, base, decs, num_pages=64, page_size=PAGE,
               **MODES[mode], **kw)


def _key_error(fn, rid) -> str:
    with pytest.raises(KeyError) as e:
        fn(rid)
    return e.value.args[0]


def _legacy_run(eng) -> dict:
    """One request per decode model over the shared context plus its tail
    on session 0, a third request aborted before it runs, then ``run``:
    the tokens and every fetch-state error on the way."""
    out = {}
    rids = {m: eng.submit(0, CTX + tail, m, gen_tokens=GEN)
            for m, tail in TAILS.items()}
    out["pending"] = _key_error(eng.result, rids["m0"])
    dropped = eng.submit(1, _tok(3, 12), "m1", gen_tokens=GEN)
    assert eng.abort(dropped)
    out["aborted"] = _key_error(eng.result, dropped)
    eng.run()
    out["tokens"] = {m: [int(t) for t in eng.result(r)]
                     for m, r in rids.items()}
    first = eng.result(rids["m0"])
    np.testing.assert_array_equal(first, eng.result(rids["m0"]))
    np.testing.assert_array_equal(first, eng.pop_result(rids["m0"]))
    out["fetched"] = _key_error(eng.result, rids["m0"])
    out["fetched_pop"] = _key_error(eng.pop_result, rids["m0"])
    out["unknown"] = _key_error(eng.result, 999)
    out["kept"] = [int(t) for t in eng.pop_result(rids["m1"])]
    return out


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's legacy run and paged ``invoke`` tokens per mode."""
    (jcfg, jbase, jdecs), _ = weights
    out = {}
    for mode in MODES:
        eng = _engine(JaxEngine, jcfg, jbase, jdecs, mode)
        out[mode] = _legacy_run(eng)
        inv = _engine(JaxEngine, jcfg, jbase, jdecs, mode)
        out[mode]["invoke"] = [int(t) for t in inv.invoke(
            0, CTX + TAILS["m1"], "m1", gen_tokens=GEN)]
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_submit_run_result_match_reference_and_generate(weights, reference,
                                                        mode):
    _, (cfg, base, decs) = weights
    eng = _engine(LocalDisaggEngine, cfg, base, decs, mode)
    with pytest.warns(DeprecationWarning,
                      match=r"LocalDisaggEngine\.submit\(\) is deprecated"):
        got = _legacy_run(eng)
    ref = reference[mode]
    assert got["tokens"] == ref["tokens"]
    assert got["kept"] == ref["tokens"]["m1"]
    fresh = _engine(LocalDisaggEngine, cfg, base, decs, mode)
    for m, tail in TAILS.items():
        new = fresh.generate(m, CTX + tail,
                             SamplingParams(max_tokens=GEN)).result()
        assert [int(t) for t in new] == got["tokens"][m]


@pytest.mark.parametrize("mode", list(MODES))
def test_fetch_state_errors_match_reference(weights, reference, mode):
    _, (cfg, base, decs) = weights
    eng = _engine(LocalDisaggEngine, cfg, base, decs, mode)
    got = _legacy_run(eng)
    ref = reference[mode]
    for state in ("pending", "aborted", "fetched", "fetched_pop", "unknown"):
        assert got[state] == ref[state], state
    assert "submitted but not finished" in got["pending"]
    assert "aborted" in got["aborted"]
    assert "already fetched" in got["fetched"]
    assert "unknown request id" in got["unknown"]
    # the abort returned the pool to its baseline: only the session's pages
    # stay held, and a second abort of the same rid is refused
    eng.end_session(0)
    eng.end_session(1)
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0
    assert not eng.abort(999)


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_invoke_matches_reference_and_warns(weights, reference, mode):
    _, (cfg, base, decs) = weights
    eng = _engine(LocalDisaggEngine, cfg, base, decs, mode)
    with pytest.warns(DeprecationWarning,
                      match=r"LocalDisaggEngine\.invoke\(\) is deprecated"):
        got = eng.invoke(0, CTX + TAILS["m1"], "m1", gen_tokens=GEN)
    assert got.dtype == np.int32
    assert [int(t) for t in got] == reference[mode]["invoke"]
    # invoke pops its own result: nothing is kept by rid
    assert not eng._results


def test_dense_invoke_matches_reference():
    """tests/test_engine_ssm.py's growing session on mamba2-780m."""
    jcfg = jget("mamba2-780m").reduced(vocab=64)
    tcfg = tget("mamba2-780m").reduced(vocab=64)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdecs = {"m0": jax_init_params(jcfg, jax.random.PRNGKey(1)),
             "m1": jax_init_params(jcfg, jax.random.PRNGKey(2))}
    ref = JaxEngine(jcfg, jbase, jdecs, capacity=128)
    eng = LocalDisaggEngine(tcfg, _bridge(jbase),
                            {m: _bridge(p) for m, p in jdecs.items()},
                            device="cpu", capacity=128)
    assert not eng.paged
    rng = np.random.default_rng(3)
    ctx = [int(t) for t in rng.integers(4, 60, size=20)]
    for mid in ("m0", "m1", "m0"):
        ctx += [int(t) for t in rng.integers(4, 60, size=5)]
        want = ref.invoke(0, ctx, mid, gen_tokens=4)
        with pytest.warns(DeprecationWarning, match=r"invoke\(\) is deprecated"):
            got = eng.invoke(0, ctx, mid, gen_tokens=4)
        np.testing.assert_array_equal(got, want)
        ctx += [int(t) for t in got]
    assert eng.stats.prefill_tokens_reused > 0
    with pytest.raises(ValueError, match="paged data plane"):
        eng.submit(0, ctx, "m0", gen_tokens=2)


PREEMPT_PAGES = 18


def _swapped_bids(cls, weights) -> dict:
    """Forced-swap contention (tests/test_torch_preempt.py's fleet): the
    swap tier's ``bids`` of every parked request at the first step that
    parks one."""
    (jcfg, jbase, _), (tcfg, tbase, _) = weights
    cfg, base = (tcfg, tbase) if cls is LocalDisaggEngine else (jcfg, jbase)
    kw = dict(device="cpu") if cls is LocalDisaggEngine else {}
    eng = cls(cfg, base, num_pages=PREEMPT_PAGES, page_size=PAGE,
              chunked=True, preempt=True, overcommit=2.0, **kw)
    eng.models.register("m", base)
    eng.swap.cfg.mode = "swap"
    return eng


def test_host_swap_pool_bids_after_forced_swap(weights):
    from repro.serving.api import SamplingParams as JSamplingParams
    got = {}
    for cls, params_cls in ((JaxEngine, JSamplingParams),
                            (LocalDisaggEngine, SamplingParams)):
        eng = _swapped_bids(cls, weights)
        for i in range(2):
            eng.generate("m", [2 + i] * 9, params_cls(max_tokens=40),
                         priority=0)
        for _ in range(4):
            eng.step()
        for i in range(2):
            eng.generate("m", [30 + i] * 17, params_cls(max_tokens=6),
                         priority=5)
        for _ in range(64):
            eng.step()
            if eng.swap.records:
                break
        assert eng.swap.records, "no request was swapped out"
        host = eng.swap.host
        got[cls] = {rid: list(host.bids(rid)) for rid in eng.swap.records}
        for rid, rec in eng.swap.records.items():
            assert got[cls][rid] == [bid for _, bid in rec.slots]
            assert rid in host
        eng.run()
        for rid in got[cls]:
            assert rid not in host
            with pytest.raises(KeyError):
                host.bids(rid)
    assert got[LocalDisaggEngine] == got[JaxEngine]


@pytest.mark.parametrize("mode", list(MODES))
def test_shared_context_warm_up_takes_a_rid_and_leaves_no_result(weights,
                                                                 mode):
    """As in the reference, a shared context's warm-up is a prefill-only
    request: it takes rid 0 in either mode and pops its empty marker."""
    _, (cfg, base, decs) = weights
    eng = _engine(LocalDisaggEngine, cfg, base, decs, mode)
    with eng.shared_context(CTX) as ctx:
        toks = ctx.generate("m0", TAILS["m0"],
                            SamplingParams(max_tokens=GEN)).result()
    assert len(toks) == GEN
    # the warm-up's prefill-only marker was popped; the generate request's
    # tokens are kept by rid, as the reference keeps every finished output
    assert list(eng._results) == [1]
    np.testing.assert_array_equal(eng.pop_result(1), toks)
    assert "already fetched" in _key_error(eng.result, 0)
