"""Mixture of experts in the port against the reference.

- ``models.moe.moe_apply`` against ``repro.models.moe.moe_apply`` on the
  reference's own ``moe_init`` weights, fp32 within 1e-5: full capacity,
  forced drops (capacity factor 0.26), padded (zero) rows, a zero router
  (every expert tied: ``lax.top_k`` keeps the lower index first), shared
  experts; ``lb_loss`` within 1e-5 and the same number of dropped choices;
- the fused plane's layout (a leading model axis, S = 1 a row, LoRA lanes
  stacking only ``wo``) against ``moe_apply`` per model and row;
- the reduced granite-moe-3b-a800m and grok-1-314b engines on the paged
  plane (vocab 64, fp32, output projections scaled so that tokens vary),
  eager, chunked and ``fused=False``: greedy tokens equal to the reference
  engine's in the same mode, and the first decode step's logits within
  1e-4; grok with the capacity factor 1.25, so that prefill drops;
- a LoRA group over an MoE base (adapters on the attention and expert
  ``wo``): the in-step lane merge bit-equal to ``lora_apply``, and its
  tokens equal to the materialized decoders'.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.lora import (LoRAPair, lora_apply, lora_init,
                                   lora_lanes, stack_lora_params)
from repro_torch.models import forward as tforward
from repro_torch.models import init_params
from repro_torch.models import moe as tmoe
from repro_torch.models.model import _layers
from repro_torch.params import params_from_numpy, tree_map
from repro_torch.serving import (DecodeModelSpec, LocalDisaggEngine,
                                 LoRAAdapter, SamplingParams)

GRANITE = "granite-moe-3b-a800m"


def _bridge(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _scaled(p, f=16.0):
    """Output projections times ``f``: with random weights a tied-embedding
    model otherwise repeats its last input token."""
    def fn(path, x):
        name = str(getattr(path[-1], "key", ""))
        return x * f if name in ("wo", "out_proj", "out") else x
    return jax.tree_util.tree_map_with_path(fn, p)


def _cfgs(name, **kw):
    j = dataclasses.replace(jget(name).reduced(d_model=64, vocab=64), **kw)
    t = dataclasses.replace(tget(name).reduced(d_model=64, vocab=64), **kw)
    return j, t


# ======================================================================
# moe_apply


MOE_CASES = {
    "full": dict(cfg={}, B=2, S=24),
    "drops": dict(cfg={"capacity_factor": 0.26}, B=2, S=24),
    "padded": dict(cfg={"capacity_factor": 1.25}, B=3, S=20, pad=True),
    "tied-router": dict(cfg={"capacity_factor": 0.26}, B=2, S=16,
                        zero_router=True),
    "shared": dict(cfg={"n_shared_experts": 1, "capacity_factor": 1.25},
                   B=2, S=24),
    "one-token": dict(cfg={}, B=5, S=1),
}


def _moe_inputs(case):
    c = MOE_CASES[case]
    jcfg, tcfg = _cfgs(GRANITE, **c["cfg"])
    p = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    if c.get("zero_router"):
        p = dict(p, router=jnp.zeros_like(p["router"]))
    x = np.random.default_rng(2).standard_normal(
        (c["B"], c["S"], jcfg.d_model)).astype(np.float32)
    if c.get("pad"):
        x[1, c["S"] // 2:] = 0.0          # a padded tail
        x[2] = 0.0                        # a padding row
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    jcfg, tcfg, p, x = _moe_inputs(case)
    want, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    got, taux = tmoe.moe_apply(_bridge(p), torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["lb_loss"]),
                               float(jaux["lb_loss"]), atol=1e-5, rtol=1e-5)
    # the same choices dropped (a mean of 0/1 flags, summed in another
    # order: equal counts, fractions within rounding)
    n = x.shape[0] * x.shape[1] * tcfg.top_k
    tf, jf = float(taux["dropped_frac"]), float(jaux["dropped_frac"])
    assert round(tf * n) == round(jf * n) and abs(tf - jf) <= 1e-6
    C = tmoe._capacity(tcfg, x.shape[1])
    assert C == jmoe._capacity(jcfg, x.shape[1])
    if case in ("drops", "tied-router"):
        assert float(taux["dropped_frac"]) > 0.1
    if case in ("full", "one-token"):
        assert float(taux["dropped_frac"]) == 0.0


def test_top_k_keeps_the_lower_index_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe._top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.tensor(np.asarray(want_v)))


def test_stacked_and_lane_layouts_match_per_row_moe():
    """The fused step's MoE: (M, B, 1, D) activations with weights stacked
    on M (full decoders), or with only ``wo`` stacked (LoRA lanes), equal
    ``moe_apply`` of each model's row alone (S = 1, nothing dropped)."""
    _, tcfg = _cfgs(GRANITE, capacity_factor=1.25)
    ps = [init_params(tcfg, s, device="cpu")["groups"]["pos0"]["moe"]
          for s in (1, 2)]
    ps = [tree_map(lambda t: t[0], p) for p in ps]
    stacked = tree_map(lambda *xs: torch.stack(xs), *ps)
    lanes = dict(ps[0], wo=stacked["wo"])
    x = torch.randn((2, 3, 1, tcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    for tree, per in ((stacked, ps), (lanes, [dict(ps[0], wo=ps[m]["wo"])
                                              for m in range(2)])):
        got, aux = tmoe.moe_apply(tree, x, tcfg)
        assert float(aux["dropped_frac"]) == 0.0
        for m in range(2):
            for b in range(3):
                want, _ = tmoe.moe_apply(per[m], x[m, b][None], tcfg)
                torch.testing.assert_close(got[m, b], want[0], atol=1e-6,
                                           rtol=1e-6)


# ======================================================================
# engines on the paged plane (granite-moe, grok)


ENGINES = {GRANITE: {}, "grok-1-314b": {"capacity_factor": 1.25}}
MODES = {"eager": {}, "chunked": dict(chunked=True, chunk_size=8,
                                      token_budget=16),
         "per-model": dict(fused=False)}


def _jobs():
    rng = np.random.default_rng(5)
    ctx = [int(t) for t in rng.integers(4, 60, 29)]
    return [(f"m{i % 2}", ctx + [int(t) for t in rng.integers(4, 60, 5)])
            for i in range(3)]


@pytest.fixture(scope="module", params=sorted(ENGINES))
def moe_engine(request):
    name = request.param
    jcfg, tcfg = _cfgs(name, **ENGINES[name])
    jbase = _scaled(jinit(jcfg, jax.random.PRNGKey(0)))
    jdecs = {f"m{i}": _scaled(jinit(jcfg, jax.random.PRNGKey(10 + i)))
             for i in range(2)}
    want = {}
    for mode, kw in MODES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ref = JaxEngine(jcfg, jbase, jdecs, num_pages=64, page_size=8,
                            **kw)
        outs = [ref.generate(m, toks, JSamplingParams(max_tokens=5))
                for m, toks in _jobs()]
        ref.run()
        want[mode] = [[int(t) for t in o.result()] for o in outs]
    # the first decode step's input: the prompt plus the first token (2)
    m, toks = _jobs()[0]
    first = np.asarray([toks + [2]], np.int32)
    jlogits, _, _ = jforward(jcfg, jdecs[m], jnp.asarray(first))
    return (tcfg, _bridge(jbase), {k: _bridge(v) for k, v in jdecs.items()},
            want, (m, first, np.asarray(jlogits)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_moe_engine_matches_reference_in_each_mode(moe_engine, mode):
    tcfg, base, decs, want, _ = moe_engine
    eng = LocalDisaggEngine(tcfg, base, decs, device="cpu", num_pages=64,
                            page_size=8, **MODES[mode])
    assert eng.paged
    outs = [eng.generate(m, toks, SamplingParams(max_tokens=5))
            for m, toks in _jobs()]
    eng.run()
    got = [o.result().tolist() for o in outs]
    assert got == want[mode]
    assert len({t for r in got for t in r}) > 1          # tokens vary
    assert eng.block_pool.free_count == 64


def test_moe_first_step_logits_match_reference(moe_engine):
    tcfg, _, decs, _, (m, first, jlogits) = moe_engine
    got, _, _ = tforward(tcfg, decs[m], torch.tensor(first))
    np.testing.assert_allclose(got.numpy(), jlogits, atol=1e-4, rtol=1e-5)


# ======================================================================
# LoRA over an MoE base


@pytest.fixture(scope="module")
def moe_lora():
    _, tcfg = _cfgs(GRANITE)
    base = _bridge(_scaled(jinit(_cfgs(GRANITE)[0], jax.random.PRNGKey(0))))
    g = torch.Generator().manual_seed(3)
    ads = []
    for _ in range(2):
        tree = lora_init(base, rank=4, generator=g)
        ads.append(tree_map(lambda x: x, tree))

    def nonzero(node):
        if isinstance(node, LoRAPair):
            return LoRAPair(node.A, 0.05 * torch.randn(node.B.shape,
                                                       generator=g))
        if isinstance(node, dict):
            return {k: nonzero(v) for k, v in node.items()}
        if isinstance(node, list):
            return [nonzero(v) for v in node]
        return node
    return tcfg, base, [nonzero(a) for a in ads]


def test_moe_lora_lane_merge_bit_equal_to_lora_apply(moe_lora):
    cfg, base, ads = moe_lora
    assert ads[0]["groups"]["pos0"]["moe"]["wo"] is not None   # experts
    merged = [lora_apply(base, a, alpha=8.0, rank=4) for a in ads]
    stacked = stack_lora_params(ads)
    per_layer = zip(_layers(cfg, base, None),
                    _layers(cfg, stacked, None, axis=1),
                    *(_layers(cfg, m, None) for m in merged))
    for (lp, _), (ab, _), *lanes in per_layer:
        got = lora_lanes(lp, ab, scale=2.0)
        assert got["moe"]["wo"].shape == (2,) + tuple(lp["moe"]["wo"].shape)
        for m, (lm, _) in enumerate(lanes):
            assert torch.equal(got["moe"]["wo"][m], lm["moe"]["wo"])
            for name in ("wq", "wv", "wo"):
                assert torch.equal(got["attn"][name][m], lm["attn"][name])
        assert got["moe"]["wi"] is lp["moe"]["wi"]
        assert got["moe"]["router"] is lp["moe"]["router"]


def test_moe_lora_group_decodes_like_materialized(moe_lora):
    cfg, base, ads = moe_lora

    def serve(register):
        eng = LocalDisaggEngine(cfg, base, device="cpu", num_pages=64,
                                page_size=8)
        register(eng)
        outs = [eng.generate(f"a{i % 2}", toks,
                             SamplingParams(max_tokens=5)) for i, (_, toks)
                in enumerate(_jobs())]
        eng.run()
        return [o.result().tolist() for o in outs], eng

    got, eng = serve(lambda e: [e.models.register(
        f"a{i}", DecodeModelSpec(lora=LoRAAdapter(a, alpha=8.0, rank=4)))
        for i, a in enumerate(ads)])
    want, _ = serve(lambda e: [e.models.register(
        f"a{i}", lora_apply(base, a, alpha=8.0, rank=4))
        for i, a in enumerate(ads)])
    assert got == want
    assert eng.stats.decode_dispatches == eng.stats.decode_steps
