"""The port's decoder stack against the reference's, on carried-across weights.

The reference builds the weights (``repro.models.init_params``); they reach
the port as numpy arrays through ``params_from_numpy``. fp32 configs, logits
within 2e-5 (matrix products sum in another order on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ATTN, ModelConfig
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.attention import attention as jax_attention
from repro.training.checkpoint import save as jax_save
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core.lora import stack_params, unstack_params
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import (decode_stacked, forward, init_cache,
                                init_params, init_stacked_params)
from repro_torch.models.attention import attention
from repro_torch.params import load_npz, params_from_numpy, tree_leaves

TOL = 2e-5
BASE = dict(arch_type="dense", d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
            vocab_size=64, dtype="float32")
# tests/test_paged_engine.py CFG, tests/test_fused_decode.py CFG_TAIL (3
# layers over a 2-layer pattern: one stacked group + one tail layer), and
# qk-norm / GQA / softcap / partial-rope variants
CONFIGS = {
    "paged-eng": dict(name="paged-eng", n_layers=2),
    "fused-tail": dict(name="fused-tail", n_layers=3,
                       layer_pattern=(ATTN, ATTN)),
    "qk-norm": dict(name="qk-norm", n_layers=2, qk_norm=True, n_heads=4,
                    n_kv_heads=2, d_model=64, rope_theta=500000.0,
                    tie_embeddings=False),
    "softcap-partial": dict(name="softcap-partial", n_layers=2,
                            attn_softcap=20.0, final_softcap=15.0,
                            rope_style="partial"),
}


def _cfgs(name):
    kw = {**BASE, **CONFIGS[name]}
    return ModelConfig(**kw), TModelConfig(**kw)


def _bridge(jcfg, seed=0):
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(rng, B, S):
    return rng.integers(4, 60, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _bridge(jcfg)
    toks = _tokens(np.random.default_rng(0), 2, 11)
    want, _, _ = jax_forward(jcfg, jp, jnp.asarray(toks), logits="all")
    got, _ = forward(tcfg, tp, torch.tensor(toks), logits="all")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["paged-eng", "fused-tail"])
def test_partial_prefill_into_dense_cache_matches_reference(name):
    """Prefill 13 tokens, then extend by 6 at pos 13 (the engine's
    partial-prefill contract): last logits and cache rows agree."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _bridge(jcfg)
    toks = _tokens(np.random.default_rng(1), 1, 19)
    jc = jax_init_cache(jcfg, 1, 32)
    _, jc, _ = jax_forward(jcfg, jp, jnp.asarray(toks[:, :13]), cache=jc)
    want, jc, _ = jax_forward(jcfg, jp, jnp.asarray(toks[:, 13:]), cache=jc,
                              pos=jnp.array([13], jnp.int32))
    tc = init_cache(tcfg, 1, 32, device="cpu")
    _, tc = forward(tcfg, tp, torch.tensor(toks[:, :13]), cache=tc)
    got, tc = forward(tcfg, tp, torch.tensor(toks[:, 13:]), cache=tc,
                      pos=torch.tensor([13], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc["groups"]["pos0"]["k"].numpy(),
                               np.asarray(jc["groups"]["pos0"]["k"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tc["groups"]["pos0"]["kpos"].numpy(),
                                  np.asarray(jc["groups"]["pos0"]["kpos"]))


@pytest.mark.parametrize("window", [0, 6], ids=["global", "window6"])
def test_flash_forward_matches_reference_flash_and_direct(window):
    """The chunked online-softmax path (forced, small chunks) against the
    reference's ``_flash`` and the port's own ``_direct``; masked cache
    slots (k_pos = -1) and a sliding window included."""
    rng = np.random.default_rng(2)
    B, Sq, Tk, Hq, Hkv, D = 2, 8, 24, 4, 2, 16
    q = rng.standard_normal((B, Sq, Hq, D), np.float32)
    k, v = (rng.standard_normal((B, Tk, Hkv, D), np.float32)
            for _ in range(2))
    q_pos = np.tile(np.arange(10, 10 + Sq, dtype=np.int32), (B, 1))
    k_pos = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    k_pos[:, 20:] = -1
    kw = dict(softcap=30.0, q_chunk=4, kv_chunk=8, window=window)
    want = jax_attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                         force_flash=True, **kw)
    targs = [torch.tensor(a) for a in (q, k, v, q_pos, k_pos)]
    got = attention(*targs, force_flash=True, **kw)
    direct = attention(*targs, force_flash=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["paged-eng", "fused-tail"])
def test_paged_decode_steps_match_dense_path(name):
    """Greedy S=1 steps over the paged pool (rows written in place, paged
    attention) give the same logits and tokens as steps over a dense
    cache."""
    _, tcfg = _cfgs(name)
    tp = init_params(tcfg, 3, device="cpu")
    prompt = _tokens(np.random.default_rng(3), 1, 13)
    page, n_steps = 8, 7
    dense = init_cache(tcfg, 1, 32, device="cpu")
    logits, dense = forward(tcfg, tp, torch.tensor(prompt), cache=dense)
    pool = PagedKVPool(tcfg, num_pages=8, page_size=page, device="cpu")
    bt = [3, 5, 1, 6]                                  # any private pages
    pool.scatter_from_dense(dense, bt, 0, 2)           # prompt rows 0..15
    tok = int(logits.argmax(-1))
    dense_toks, paged_toks = [], []
    t_d = t_p = tok
    for i in range(n_steps):
        pos = torch.tensor([13 + i], dtype=torch.int32)
        ld, dense = forward(tcfg, tp, torch.tensor([[t_d]]), cache=dense,
                            pos=pos)
        cache = pool.make_decode_cache(torch.tensor([bt], dtype=torch.int32))
        lp, _ = forward(tcfg, tp, torch.tensor([[t_p]]), cache=cache, pos=pos)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=TOL, rtol=TOL)
        t_d, t_p = int(ld.argmax(-1)), int(lp.argmax(-1))
        dense_toks.append(t_d)
        paged_toks.append(t_p)
    assert paged_toks == dense_toks
    assert not pool.k_groups["pos0"][:, 0].any()        # sentinel untouched


def test_decode_stacked_matches_per_model_forward():
    """One fused step over M=2 stacked decoders (with a padding row on
    sentinel page 0) equals each model's own paged step."""
    _, tcfg = _cfgs("fused-tail")
    stacked = init_stacked_params(tcfg, [5, 6], device="cpu")
    models = unstack_params(stacked, 2)
    pool = PagedKVPool(tcfg, num_pages=8, page_size=8, device="cpu")
    for a in pool.k_groups["pos0"], pool.v_groups["pos0"], *pool.k_tail, \
            *pool.v_tail:
        a.normal_(generator=torch.Generator().manual_seed(0))
    bts = np.array([[1, 2], [3, 0], [0, 0], [4, 5]], np.int32)  # row 2: pad
    pos = np.array([[9, 3], [0, 12]], np.int32)
    toks = np.array([[7, 8], [0, 9]], np.int32)
    ref_pool = {k: [t.clone() for t in v] for k, v in
                zip(("k", "v"), pool.layers())}
    got = decode_stacked(tcfg, stacked, torch.tensor(toks), torch.tensor(pos),
                         *pool.layers(), torch.tensor(bts))
    for m, b in [(0, 0), (0, 1), (1, 1)]:
        single = PagedKVPool(tcfg, num_pages=8, page_size=8, device="cpu")
        for dst, src in zip(single.layers()[0], ref_pool["k"]):
            dst.copy_(src)
        for dst, src in zip(single.layers()[1], ref_pool["v"]):
            dst.copy_(src)
        cache = single.make_decode_cache(torch.tensor(bts[m * 2 + b][None]))
        want, _ = forward(tcfg, models[m], torch.tensor([[toks[m, b]]]),
                          cache=cache, pos=torch.tensor([pos[m, b]]))
        np.testing.assert_allclose(got[m, b].numpy(), want[0].numpy(),
                                   atol=TOL, rtol=TOL)


def test_init_params_tree_matches_reference_layout():
    """Same keys, shapes and stacked axes as the reference's init; stacked
    init equals per-model init, and re-stacking its views copies nothing."""
    jcfg, tcfg = _cfgs("fused-tail")
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(tcfg, 0, device="cpu")
    tshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jax.tree.map(np.asarray, jax.tree.map(
                               lambda t: t.numpy(), tp)))
    assert tshapes == jshapes
    stacked = init_stacked_params(tcfg, [0, 1], device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(stacked)):
        assert torch.equal(a, b[0])
    restacked = stack_params(unstack_params(stacked, 2))
    for a, b in zip(tree_leaves(stacked), tree_leaves(restacked)):
        assert a.data_ptr() == b.data_ptr()


def test_load_npz_reads_reference_checkpoint(tmp_path):
    jcfg, tcfg = _cfgs("fused-tail")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    jax_save(str(tmp_path / "ckpt"), jp)
    tp = params_from_numpy(load_npz(str(tmp_path / "ckpt.npz")),
                           device="cpu")
    toks = _tokens(np.random.default_rng(4), 1, 9)
    want, _, _ = jax_forward(jcfg, jp, jnp.asarray(toks))
    got, _ = forward(tcfg, tp, torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
