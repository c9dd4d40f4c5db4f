"""The dense fallback of the port's engine against the reference's.

Archs whose sequence state is not paged global-attention KV serve with
``paged=False``: one dense cache per session, extended in place, copied to
the decode model at each request (``transfer_cache``), decoded by the B=1
loop. At ``reduced(vocab=64)`` width, fp32, on the reference's weights
(output projections scaled so that tokens vary), each arch serves one
growing session through ``LocalDisaggEngine.generate`` in both engines
(tests/test_engine_ssm.py's traffic), then a seeded sampled request:

- mamba2-780m (SSD state), recurrentgemma-2b (RG-LRU + windows),
  gemma2-27b (a context of ~100 tokens past its 64-token window: the
  reference's window caches drop keys there, and the port matches it),
  seamless-m4t-medium (enc-dec served on tokens, an empty cross cache) and
  internvl2-76b (mixed input served on tokens);
- greedy and seeded tokens equal to the reference engine's; the engine's
  first decode step's logits (base prefill, handoff copy, one decoder
  step) within 1e-4 of the reference's; the prefill, reuse and handoff
  counters equal;
- ``end_session`` and a one-shot session's release return the manager's
  pages; ``sanitize=True``, ``preempt=True`` and ``fused=True`` raise with
  the dense plane, and a shared context is refused, as in the reference;
  ``autoscale=`` raises too (the reference asserts at its first hot-join).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.prefillshare import base_prefill as jbase_prefill
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.prefillshare import base_prefill
from repro_torch.kvcache.handoff import transfer_cache
from repro_torch.models import forward
from repro_torch.params import params_from_numpy
from repro_torch.serving import LocalDisaggEngine, SamplingParams
from repro_torch.serving.autoscale import AutoscaleConfig

ARCHS = ["mamba2-780m", "recurrentgemma-2b", "gemma2-27b",
         "seamless-m4t-medium", "internvl2-76b"]
SAMPLED = dict(max_tokens=5, temperature=0.8, top_k=20, top_p=0.9, seed=5)
STATS = ("prefill_tokens_computed", "prefill_tokens_reused", "handoffs",
         "handoff_bytes", "prefix_hit_tokens", "prefix_total_tokens")


def _scaled(p, f=16.0):
    def fn(path, x):
        name = str(getattr(path[-1], "key", ""))
        return x * f if name in ("wo", "out_proj", "out") else x
    return jax.tree_util.tree_map_with_path(fn, p)


def _bridge(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _serve(eng, params_cls, n0):
    """tests/test_engine_ssm.py's session: a context of n0 tokens, then
    three requests, each appending 5 tokens and then its own answer; then
    a seeded sampled request on the session. Returns (tokens, sampled)."""
    rng = np.random.default_rng(3)
    ctx = [int(t) for t in rng.integers(4, 60, n0)]
    outs = []
    for mid in ("m0", "m1", "m0"):
        ctx = ctx + [int(t) for t in rng.integers(4, 60, 5)]
        out = eng.generate(mid, ctx, params_cls(max_tokens=4), session=0)
        outs.append([int(t) for t in out.result()])
        ctx = ctx + outs[-1]
    sampled = eng.generate("m1", ctx, params_cls(**SAMPLED), session=0)
    return outs, [int(t) for t in sampled.result()], ctx


@pytest.fixture(scope="module", params=ARCHS)
def dense_case(request):
    name = request.param
    jcfg = jget(name).reduced(vocab=64)
    tcfg = tget(name).reduced(vocab=64)
    n0 = 80 if name == "gemma2-27b" else 20     # gemma2: past the window
    jbase = _scaled(jinit(jcfg, jax.random.PRNGKey(0)))
    jdecs = {f"m{i}": _scaled(jinit(jcfg, jax.random.PRNGKey(1 + i)))
             for i in range(2)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = JaxEngine(jcfg, jbase, jdecs, capacity=160)
    assert not ref.paged
    toks, sampled, ctx = _serve(ref, JSamplingParams, n0)
    stats = {k: ref.stats()[k] for k in STATS}
    # the engine's first decode step: base prefill, then one decoder step
    # at the context's end on a copy of the cache
    c = jnp.asarray([ctx], jnp.int32)
    _, cache = jbase_prefill(jcfg, jbase, c, cache_len=160)
    first, _, _ = jforward(jcfg, jdecs["m0"], jnp.asarray([[2]], jnp.int32),
                           cache=cache, pos=jnp.asarray([len(ctx)],
                                                        jnp.int32))
    port = (tcfg, _bridge(jbase), {k: _bridge(v) for k, v in jdecs.items()})
    return name, n0, port, (toks, sampled, stats, ctx, np.asarray(first))


def _engine(port, **kw):
    tcfg, base, decs = port
    return LocalDisaggEngine(tcfg, base, decs, device="cpu", capacity=160,
                             **kw)


def test_dense_engine_matches_reference(dense_case):
    name, n0, port, (want, want_sampled, want_stats, _, _) = dense_case
    eng = _engine(port)
    assert not eng.paged and eng.decode_plane is None
    got, sampled, ctx = _serve(eng, SamplingParams, n0)
    assert got == want
    assert sampled == want_sampled
    assert len({t for r in got for t in r}) > 1            # tokens vary
    assert {k: eng.stats()[k] for k in STATS} == want_stats
    assert eng.stats.prefill_tokens_reused > 0
    if name == "gemma2-27b":
        assert len(ctx) > tget(name).reduced().sliding_window + 40


def test_dense_first_step_logits_match_reference(dense_case):
    _, _, (tcfg, base, decs), (_, _, _, ctx, want) = dense_case
    _, cache = base_prefill(tcfg, base, torch.tensor([ctx],
                                                     dtype=torch.int32),
                            cache_len=160)
    got, _, _ = forward(tcfg, decs["m0"],
                        torch.tensor([[2]], dtype=torch.int32),
                        cache=transfer_cache(cache),
                        pos=torch.tensor([len(ctx)], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_sessions_release_their_pages(dense_case):
    """A one-shot request (``session=None``) releases its accounting pages
    when it finishes; a held session keeps its pages until
    ``end_session``."""
    _, _, port, _ = dense_case
    eng = _engine(port)
    pool = eng.prefill_workers[0].mgr.pool
    out = eng.generate("m0", list(range(4, 40)), SamplingParams(max_tokens=3))
    assert out.finished and len(out.tokens) == 3
    assert pool.active_count == 0 and not eng.prefill_workers[0].sessions
    eng.generate("m1", list(range(4, 40)), SamplingParams(max_tokens=3),
                 session=7)
    assert pool.active_count > 0 and 7 in eng.prefill_workers[0].sessions
    eng.end_session(7)
    assert pool.active_count == 0 and not eng.prefill_workers[0].sessions
    pool.check_invariants()


@pytest.mark.parametrize("kw,match", [
    (dict(sanitize=True), "sanitize=True requires the paged KV plane"),
    (dict(preempt=True), "preempt=True requires the paged KV plane"),
    (dict(fused=True), "fused decode requires the paged data plane"),
    (dict(paged=True), "not eligible for paged plane"),
    (dict(autoscale=AutoscaleConfig()), "autoscale requires the paged KV"),
])
def test_dense_plane_refuses_paged_options(kw, match):
    cfg = tget("mamba2-780m").reduced(vocab=64)
    from repro_torch.models import init_params
    base = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        LocalDisaggEngine(cfg, base, device="cpu", **kw)
    eng = LocalDisaggEngine(cfg, base, device="cpu")
    with pytest.raises(ValueError, match="shared contexts require"):
        eng.shared_context([5, 6, 7])
