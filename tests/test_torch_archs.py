"""Every assigned architecture in the port against the reference, at
``reduced()`` width, on the reference's own weights (carried across with
``params_from_numpy``), fp32:

- ``forward`` logits within 2e-5 of ``repro.models.forward`` (an fp32
  stack of a few layers; the sums round in another order), the MoE ``aux``
  within 1e-5;
- ``init_cache`` shapes and dtypes equal to the reference's;
- a cached prefill and one decode step within 2e-5 of the reference's,
  and the decode step within 2e-3 of the full forward
  (tests/test_archs_smoke.py::test_reduced_decode_matches_full_forward);
- ``encode`` (seamless-m4t-medium) and ``prefix_embeds`` (internvl2-76b's
  mixed input) against the reference;
- gemma2-27b's window caches keep the reference's behaviour past the
  window: a 100-token cached prefill over a 64-token window differs from
  the no-cache forward exactly as the reference's does;
- every leaf keeps its dtype: a bf16 reference tree carried across, and
  the port's own ``init_params``, hold the reference's fp32 leaves (router,
  SSD and RG-LRU parameters) in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as jget
from repro.models import encode as jencode
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.models import encode as tencode
from repro_torch.models import forward as tforward
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params
from repro_torch.params import params_from_numpy, tree_leaves

TOL = dict(atol=2e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module", params=ASSIGNED)
def arch(request):
    """(name, reference cfg, port cfg, reference params, port params,
    tokens, reference kwargs, port kwargs)."""
    name = request.param
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jkw, tkw = {}, {}
    if jcfg.is_encdec:
        e = (0.1 * rng.standard_normal((2, 10, jcfg.d_model))).astype(
            np.float32)
        jkw["enc_out"] = jencode(jcfg, jp, jnp.asarray(e))
        tkw["enc_out"] = tencode(tcfg, tp, torch.tensor(e))
    if jcfg.input_mode == "mixed":
        pe = (0.1 * rng.standard_normal(
            (2, jcfg.n_prefix_embeds, jcfg.d_model))).astype(np.float32)
        jkw["prefix_embeds"] = jnp.asarray(pe)
        tkw["prefix_embeds"] = torch.tensor(pe)
    return name, jcfg, tcfg, jp, tp, toks, jkw, tkw


def test_forward_logits_match_reference(arch):
    _, jcfg, tcfg, jp, tp, toks, jkw, tkw = arch
    want, _, jaux = jforward(jcfg, jp, jnp.asarray(toks), logits="all", **jkw)
    got, _, taux = tforward(tcfg, tp, torch.tensor(toks), logits="all",
                            **tkw)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for k in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-5)
    if jcfg.is_moe:
        assert float(taux["lb_loss"]) > 0


def test_init_cache_matches_reference(arch):
    _, jcfg, tcfg, *_ = arch
    enc = 10 if jcfg.is_encdec else 0
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jinit_cache(jcfg, 2, 20, enc_len=enc))
    got = jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")),
        tinit_cache(tcfg, 2, 20, device="cpu", enc_len=enc))
    assert got == want


def test_cached_prefill_and_decode_match_reference(arch):
    """The reference's decode-vs-full-forward check on both stacks, and the
    cached paths held to each other."""
    _, jcfg, tcfg, jp, tp, toks, jkw, tkw = arch
    B, S = toks.shape
    npfx = jcfg.n_prefix_embeds if jcfg.input_mode == "mixed" else 0
    enc = 10 if jcfg.is_encdec else 0
    jc = jinit_cache(jcfg, B, S + npfx + 4, enc_len=enc)
    tc = tinit_cache(tcfg, B, S + npfx + 4, device="cpu", enc_len=enc)
    jo, jc, _ = jforward(jcfg, jp, jnp.asarray(toks), cache=jc,
                         pos=jnp.zeros(B, jnp.int32), **jkw)
    to, tc, _ = tforward(tcfg, tp, torch.tensor(toks), cache=tc,
                         pos=torch.zeros(B, dtype=torch.int32), **tkw)
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
    nt = _np(jnp.argmax(jo, -1))[:, None].astype(np.int32)
    jo2, _, _ = jforward(jcfg, jp, jnp.asarray(nt), cache=jc,
                         pos=jnp.full((B,), S + npfx, jnp.int32))
    to2, _, _ = tforward(tcfg, tp, torch.tensor(nt), cache=tc,
                         pos=torch.full((B,), S + npfx, dtype=torch.int32))
    np.testing.assert_allclose(to2.numpy(), _np(jo2), **TOL)
    full, _, _ = tforward(tcfg, tp,
                          torch.tensor(np.concatenate([toks, nt], 1)),
                          logits="all", **tkw)
    assert float((to2 - full[:, -1]).abs().max()) < 2e-3


def test_encode_matches_reference():
    jcfg = jget("seamless-m4t-medium").reduced()
    tcfg = tget("seamless-m4t-medium").reduced()
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    e = np.random.default_rng(1).standard_normal(
        (2, 17, jcfg.d_model)).astype(np.float32)
    want = jencode(jcfg, jp, jnp.asarray(e))
    got = tencode(tcfg, tp, torch.tensor(e))
    assert got.shape == e.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("name,mode", [("internvl2-76b", "mixed"),
                                       ("seamless-m4t-medium", "encdec")])
def test_input_modes_without_prefix_run_on_tokens(name, mode):
    """With no ``prefix_embeds`` (and no encoder output for enc-dec, whose
    cross cache is then empty), the forward runs on token embeddings alone,
    as the reference does: the engine's dense fallback serves these archs
    this way."""
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    jp = jinit(jcfg, jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, 512, (1, 9)).astype(np.int32)
    jc, tc = jinit_cache(jcfg, 1, 16), tinit_cache(tcfg, 1, 16, device="cpu")
    want, _, _ = jforward(jcfg, jp, jnp.asarray(toks), cache=jc)
    got, _, _ = tforward(tcfg, tp, torch.tensor(toks), cache=tc)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_window_cache_past_the_window_matches_reference():
    """gemma2-27b reduced (window 64): a 100-token prefill into a cache
    keeps only the last 64 keys in its sliding-window layers, so its last
    logits differ from the no-cache forward's; the port reproduces the
    reference's cached result, not the forward's."""
    jcfg, tcfg = jget("gemma2-27b").reduced(), tget("gemma2-27b").reduced()
    assert jcfg.sliding_window == 64
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for S, differs in ((40, False), (100, True)):
        toks = np.random.default_rng(S).integers(0, 512, (1, S)).astype(
            np.int32)
        jc, _, _ = jforward(jcfg, jp, jnp.asarray(toks),
                            cache=jinit_cache(jcfg, 1, 128))
        tc, _, _ = tforward(tcfg, tp, torch.tensor(toks),
                            cache=tinit_cache(tcfg, 1, 128, device="cpu"))
        free, _, _ = tforward(tcfg, tp, torch.tensor(toks))
        np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
        gap = float((tc - free).abs().max())
        assert (gap > 1e-2) == differs, (S, gap)


# ======================================================================
# leaf dtypes (params_from_numpy, _Init)


BF16_ARCHS = ["granite-moe-3b-a800m", "mamba2-780m", "recurrentgemma-2b"]


def _bf16(name, cfg_fn):
    import dataclasses
    return dataclasses.replace(cfg_fn(name).reduced(), dtype="bfloat16")


@pytest.mark.parametrize("name", BF16_ARCHS)
def test_leaf_dtypes_carry_across_and_match_init(name):
    jcfg, tcfg = _bf16(name, jget), _bf16(name, tget)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: str(x.dtype), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got = jax.tree.map(lambda x: str(x.dtype).removeprefix("torch."), tp)
    assert got == want
    fp32 = {str(x.dtype) for x in jax.tree.leaves(jp)}
    assert fp32 == {"bfloat16", "float32"}       # mixed, as in the config
    own = init_params(tcfg, 0, device="cpu")
    assert jax.tree.map(lambda x: str(x.dtype).removeprefix("torch."),
                        own) == want
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [tuple(x.shape) for x in tree_leaves(tp)]


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "internvl2-76b"])
def test_base_prefill_with_embeds_matches_reference(name):
    """``core.prefillshare.base_prefill`` with ``enc_embeds`` (the encoder's
    output fills the cross cache) or ``prefix_embeds`` (patch embeddings
    ahead of the tokens), then a decode step from that cache."""
    from repro.core.prefillshare import base_prefill as jbase_prefill
    from repro_torch.core.prefillshare import base_prefill
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    jp = jinit(jcfg, jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    e = (0.1 * rng.standard_normal(
        (2, 6 if jcfg.is_encdec else jcfg.n_prefix_embeds,
         jcfg.d_model))).astype(np.float32)
    key = "enc_embeds" if jcfg.is_encdec else "prefix_embeds"
    jo, jc = jbase_prefill(jcfg, jp, jnp.asarray(toks), cache_len=24,
                           **{key: jnp.asarray(e)})
    to, tc = base_prefill(tcfg, tp, torch.tensor(toks), cache_len=24,
                          **{key: torch.tensor(e)})
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
    n = toks.shape[1] + (0 if jcfg.is_encdec else e.shape[1])
    nt = np.full((2, 1), 3, np.int32)
    jd, _, _ = jforward(jcfg, jp, jnp.asarray(nt), cache=jc,
                        pos=jnp.full((2,), n, jnp.int32))
    td, _, _ = tforward(tcfg, tp, torch.tensor(nt), cache=tc,
                        pos=torch.full((2,), n, dtype=torch.int32))
    np.testing.assert_allclose(td.numpy(), _np(jd), **TOL)
