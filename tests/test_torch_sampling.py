"""The port's sampler (repro_torch.serving.sampling) against the reference's.

- keys, random bits and uniforms equal ``jax.random``'s bit for bit over a
  sweep of seeds (0, 1, 7, 2**31 - 1, -1, -2**31) and positions (0, 4095
  and 30 drawn from [0, 4096) with a fixed numpy seed), at V = 97 and 32000;
- Gumbel noise within 4 ulp: the inner ``-log(u)`` in ulps of its own value,
  the noise ``-log(-log(u))`` in ulps of max(|g|, 1) (near g = 0 a one-ulp
  difference in the inner log is many ulps of g itself, and the noise is
  added to logits of magnitude >= 1 anyway);
- tokens from ``sample_logits`` on identical logits over the grid
  temperature {0, 0.7, 1.5} x top_k {0, 1, 5} x top_p {1, 0.9, 0.5}: every
  row equals the reference's, except a row whose two largest perturbed
  scores (reference Gumbel noise plus the scaled logits) differ by less than
  1e-5 * max(1, |score|); such rows are counted, printed, and must be at
  most 1% of the rows;
- the engine analogues of tests/test_api.py:53, 67, 93, 142, 152 and
  tests/test_registry.py:233, on the port's CPU engine with carried-across
  weights; an all-greedy batch never calls the sampler.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving import sampling as R
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.params import params_from_numpy
from repro_torch.serving import (DecodeModelSpec, LocalDisaggEngine,
                                 SamplingParams)
from repro_torch.serving import decode as decode_mod
from repro_torch.serving import sampling as S

SEEDS = (0, 1, 7, 2**31 - 1, -1, -2**31)
POSITIONS = np.concatenate([[0, 4095], np.random.default_rng(123).integers(
    0, 4096, 30)]).astype(np.int32)
TINY = float(jnp.finfo(jnp.float32).tiny)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@jax.jit
def _jax_keys(seeds, pos):
    return jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.PRNGKey(s), p))(seeds, pos)


@pytest.mark.parametrize("V", [97, 32000])
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniform_and_gumbel_match_jax(seed, V):
    seeds = np.full(len(POSITIONS), seed, np.int32)
    jkeys = _jax_keys(jnp.asarray(seeds), jnp.asarray(POSITIONS))
    tkeys = S.fold_keys(_t(seeds), _t(POSITIONS))
    np.testing.assert_array_equal(np.asarray(jkeys).astype(np.int64),
                                  tkeys.numpy())
    # PRNGKey alone
    np.testing.assert_array_equal(
        np.asarray(jax.random.PRNGKey(np.int32(seed))).astype(np.int64),
        S.prng_key(torch.tensor([seed], dtype=torch.int32))[0].numpy())

    bits = jax.jit(jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32)))
    np.testing.assert_array_equal(np.asarray(bits(jkeys)).astype(np.int64),
                                  S.random_bits(tkeys, V).numpy())
    unif = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), jnp.float32, TINY, 1.0)))
    ju, tu = np.asarray(unif(jkeys)), S.uniform(tkeys, V, TINY, 1.0).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    unif01 = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (V,))))
    np.testing.assert_array_equal(np.asarray(unif01(jkeys)),
                                  S.uniform(tkeys, V).numpy())

    inner_j = np.asarray(-jnp.log(jnp.asarray(tu)))
    inner_t = (-torch.log(_t(tu))).numpy()
    assert _ulps(inner_j, inner_t).max() <= 4
    gum = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32)))
    jg, tg = np.asarray(gum(jkeys)), S.gumbel(tkeys, V).numpy()
    scale = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(jg - tg) / scale).max() <= 4


def _grid_rows(temp, k, p, rng, N, V):
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    seeds = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    pos = rng.integers(0, 4096, N).astype(np.int32)
    T = np.full(N, temp, np.float32)
    K = np.full(N, k, np.int32)
    P = np.full(N, p, np.float32)
    return logits, seeds, pos, T, K, P


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.5])
def test_sample_logits_matches_reference_up_to_near_ties(temp):
    """Nine (top_k, top_p) cells of 64 rows over a 1000-token vocabulary."""
    rng = np.random.default_rng(int(temp * 10))
    N, V = 64, 1000
    ref = jax.jit(R.sample_step)
    rows = flips = ties = 0
    for k, p in itertools.product([0, 1, 5], [1.0, 0.9, 0.5]):
        logits, seeds, pos, T, K, P = _grid_rows(temp, k, p, rng, N, V)
        want = np.asarray(ref(*map(jnp.asarray, (logits, pos, T, K, P,
                                                 seeds))))
        got = S.sample_step(*map(_t, (logits, pos, T, K, P, seeds))).numpy()
        rows += N
        bad = np.nonzero(want != got)[0]
        if not len(bad):
            continue
        assert temp > 0, "greedy rows must be exact"
        # the reference's perturbed scores of the differing rows: its own
        # Gumbel noise plus the filtered, scaled logits
        keys = R.fold_keys(jnp.asarray(seeds[bad]), jnp.asarray(pos[bad]))
        noise = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
            kk, (V,), jnp.float32))(keys))
        scaled = _scaled(logits[bad], T[bad], K[bad], P[bad])
        score = np.sort(noise + scaled, -1)[:, -2:]
        gap = score[:, 1] - score[:, 0]
        near = gap < 1e-5 * np.maximum(1.0, np.abs(score[:, 1]))
        assert near.all(), (k, p, gap[~near])
        ties += int(near.sum())
        flips += len(bad)
    print(f"temperature {temp}: {flips} of {rows} rows differ, all near-ties")
    assert ties <= 0.01 * rows


def _scaled(logits, T, K, P):
    """The reference's filtered, temperature-scaled logits (its
    ``sample_logits`` up to the draw), in jnp."""
    lg = jnp.asarray(logits)
    V = lg.shape[-1]
    neg = jnp.finfo(jnp.float32).min
    ranks = jnp.argsort(jnp.argsort(-lg, axis=-1), axis=-1)
    k = jnp.where(K > 0, jnp.minimum(K, V), V)
    fk = jnp.where(ranks < k[:, None], lg, neg)
    fk_idx = jnp.argsort(-fk, axis=-1)
    probs = jax.nn.softmax(jnp.take_along_axis(fk, fk_idx, axis=-1), -1)
    cum = jnp.cumsum(probs, -1)
    keep = jnp.take_along_axis((cum - probs) < P[:, None],
                               jnp.argsort(fk_idx, axis=-1), axis=-1)
    return np.asarray(jnp.where(keep, fk, neg)
                      / jnp.maximum(T, 1e-6)[:, None])


def test_top_p_renormalizes_over_top_k_survivors():
    """tests/test_api.py:152 on the port: probs (.4, .3, .2, .1) with
    top_k=2 renormalize to (4/7, 3/7), so top_p=0.55 keeps only the
    argmax; without the top-k squeeze top_p=0.55 keeps tokens {0, 1}."""
    lg = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
    one = torch.tensor([1.0])

    def draw(sp, top_k):
        keys = S.fold_keys(torch.tensor([sp], dtype=torch.int32),
                           torch.tensor([sp], dtype=torch.int32))
        return int(S.sample_logits(lg, one, torch.tensor([top_k]),
                                   torch.tensor([0.55]), keys)[0])
    assert all(draw(sp, 2) == 0 for sp in range(20))
    assert {draw(sp, 0) for sp in range(40)} == {0, 1}


# ======================================================================
# engine analogues (tests/test_api.py, tests/test_registry.py)


CFG_KW = dict(name="samp-eng", arch_type="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
              dtype="float32")
PAGE = 8


@pytest.fixture(scope="module")
def weights():
    cfg = ModelConfig(**CFG_KW)

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    base = bridge(jax_init_params(cfg, jax.random.PRNGKey(0)))
    decs = {f"m{i}": bridge(jax_init_params(cfg, jax.random.PRNGKey(10 + i)))
            for i in range(3)}
    return TModelConfig(**CFG_KW), base, decs


def _engine(weights, models=("m0", "m1"), **kw):
    cfg, base, decs = weights
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    eng = LocalDisaggEngine(cfg, base, device="cpu", **kw)
    for m in models:
        eng.models.register(m, DecodeModelSpec(full=decs[m]))
    return eng


def _ctx(seed=0, n=19):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 60, n)]


MODES = {"fused": {}, "per-model": {"fused": False},
         "chunked": {"chunked": True, "chunk_size": 5, "token_budget": 16}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_temperature_zero_is_the_greedy_path(weights, mode):
    """tests/test_api.py:53: temperature 0 with any top_k/top_p/seed gives
    the default greedy tokens, in every decode mode."""
    ctx = _ctx(0)
    want = _engine(weights).generate(
        "m0", ctx, SamplingParams(max_tokens=6)).result()
    got = _engine(weights, **MODES[mode]).generate(
        "m0", ctx, SamplingParams(max_tokens=6, top_k=3, top_p=0.5,
                                  seed=99)).result()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_seeded_sampling_reproducible_regardless_of_batch_packing(weights,
                                                                  mode):
    """tests/test_api.py:67: a seeded stream alone equals the same request
    packed with greedy and other sampled traffic of both models."""
    ctx = _ctx(1)
    sp = SamplingParams(max_tokens=6, temperature=0.8, top_k=12, seed=7)
    solo = _engine(weights).generate("m0", ctx, sp).result()
    busy = _engine(weights, **MODES[mode])
    busy.generate("m1", _ctx(2, 13), SamplingParams(max_tokens=9,
                                                    temperature=1.3, seed=3))
    busy.generate("m0", _ctx(3, 27), SamplingParams(max_tokens=4))
    got = busy.generate("m0", ctx, sp)
    busy.run()
    np.testing.assert_array_equal(solo, got.tokens)


def test_default_seed_gives_independent_fanout_draws(weights):
    """tests/test_api.py:93: seed=None draws with the request id as the
    seed, visible on the handle; three fan-outs differ."""
    eng = _engine(weights)
    sp = SamplingParams(max_tokens=6, temperature=1.0)
    outs = [eng.generate("m0", _ctx(30), sp) for _ in range(3)]
    eng.run()
    assert len({tuple(o.tokens) for o in outs}) > 1
    assert [o.params.seed for o in outs] == [o.request_id for o in outs]


def test_top_k_one_is_greedy_even_at_high_temperature(weights):
    """tests/test_api.py:142."""
    greedy = _engine(weights).generate(
        "m0", _ctx(4), SamplingParams(max_tokens=5)).result()
    forced = _engine(weights).generate(
        "m0", _ctx(4), SamplingParams(max_tokens=5, temperature=5.0,
                                      top_k=1, seed=11)).result()
    np.testing.assert_array_equal(greedy, forced)


def test_seeded_stream_unchanged_across_lane_remap(weights):
    """tests/test_registry.py:233: a seeded stream survives churn that
    remaps its fused-plane lane."""
    sp = SamplingParams(max_tokens=8, temperature=0.9, top_k=12, seed=13)
    solo = _engine(weights, models=("m1",)).generate(
        "m1", _ctx(50), sp).result()
    eng = _engine(weights, models=("m0", "m1"))
    got = eng.generate("m1", _ctx(50), sp)
    eng.generate("m0", _ctx(51, 12), SamplingParams(max_tokens=3))
    for _ in range(2):
        eng.step()
    eng.models.register("m2", DecodeModelSpec(full=weights[2]["m2"]))
    eng.run()
    eng.models.unregister("m0")
    got2 = eng.generate("m1", _ctx(50), sp)
    eng.run()
    np.testing.assert_array_equal(solo, got.tokens)
    np.testing.assert_array_equal(solo, got2.result())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-model"])
def test_all_greedy_batch_never_calls_the_sampler(weights, monkeypatch,
                                                  fused):
    """An all-greedy batch runs argmax only; one sampled request in the
    batch makes every step of that batch run the sampler."""
    calls = []
    real = decode_mod.sample_step
    monkeypatch.setattr(decode_mod, "sample_step",
                        lambda *a: calls.append(1) or real(*a))
    eng = _engine(weights, fused=fused)
    eng.generate("m0", _ctx(5), SamplingParams(max_tokens=4))
    eng.generate("m1", _ctx(6), SamplingParams(max_tokens=4))
    eng.run()
    assert calls == []
    eng.generate("m0", _ctx(5), SamplingParams(max_tokens=4,
                                               temperature=0.5, seed=1))
    eng.run()
    assert len(calls) == 4
