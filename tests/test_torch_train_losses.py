"""The port's training losses and their gradients against ``jax.grad``.

The reference builds the weights; they reach the port as numpy arrays
(``params_from_numpy``), and the inputs come from a numpy seed. Each loss
(``train_loss``, Eq. 7's ``cache_conditioned_loss`` at share ratios 1, 0.5
and 0, ``full_ft_loss``, ``cache_conditioned_lora_loss``) is compared on
its value and on EVERY gradient leaf, in fp32, within rtol 1e-4 / atol
1e-5, on tests/test_prefillshare.py's dense config here and on an MoE and a
recurrent ``reduced()`` config in tests/test_torch_train_losses_archs.py.
Also: the frozen base gets exactly zero gradient, ``mix_caches`` takes the
reference's layers bit for bit, ``remat`` changes no value, and the
functional cache path leaves serving's tokens and in-place writes as they
were.
"""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ATTN, ModelConfig
from repro.configs.base import get_config as jax_get_config
from repro.core.lora import cache_conditioned_lora_loss as jax_lora_loss
from repro.core.lora import lora_init as jax_lora_init
from repro.core.prefillshare import _layer_share_mask as jax_share_mask
from repro.core.prefillshare import base_prefill as jax_base_prefill
from repro.core.prefillshare import cache_conditioned_loss as jax_cc_loss
from repro.core.prefillshare import full_ft_loss as jax_full_ft_loss
from repro.core.prefillshare import mix_caches as jax_mix_caches
from repro.models import init_params as jax_init_params
from repro.models.model import train_loss as jax_train_loss
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import get_config
from repro_torch.core.lora import cache_conditioned_lora_loss
from repro_torch.core.prefillshare import (_layer_share_mask, base_prefill,
                                           cache_conditioned_loss,
                                           full_ft_loss, mix_caches)
from repro_torch.models import attention as attn_mod
from repro_torch.models import forward, init_cache
from repro_torch.models.model import train_loss
from repro_torch.params import (adapters_from_numpy, params_from_numpy,
                                tree_leaves, tree_map)
from repro_torch.training.optim import AdamW
from repro_torch.training.trainer import Trainer, _greedy

RTOL, ATOL = 1e-4, 1e-5
DENSE = dict(name="t", arch_type="dense", n_layers=4, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
REDUCED = {"moe": "granite-moe-3b-a800m", "recurrent": "recurrentgemma-2b",
           "mixed": "internvl2-76b", "encdec": "seamless-m4t-medium"}
LORA = dict(alpha=8.0, rank=4)


@functools.lru_cache(maxsize=None)
def _cfgs(name):
    if name == "dense":
        return ModelConfig(**DENSE), TModelConfig(**DENSE)
    return (jax_get_config(REDUCED[name]).reduced(d_model=64, vocab=64),
            get_config(REDUCED[name]).reduced(d_model=64, vocab=64))


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(jax base, jax dec, port base, port dec): seeds 0 and 1."""
    jcfg, _ = _cfgs(name)
    init = jax.jit(jax_init_params, static_argnums=0)   # faster than eager
    jb, jd = (init(jcfg, jax.random.PRNGKey(s)) for s in (0, 1))
    return jb, jd, *(params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
                     for p in (jb, jd))


def _task(seed=0, B=2, Sp=8, St=6):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(4, 60, (B, Sp)).astype(np.int32)
    ti, to = (rng.integers(4, 60, (B, St)).astype(np.int32)
              for _ in range(2))
    mask = np.ones((B, St), np.float32)
    mask[1, -2:] = 0.0                       # a ragged answer
    return prompt, ti, to, mask


def _lm(seed=1, B=2, S=12):
    rng = np.random.default_rng(seed)
    toks, tgt = (rng.integers(4, 60, (B, S)).astype(np.int32)
                 for _ in range(2))
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return toks, tgt, mask


def _embeds(cfg, seed=2, B=2):
    """A mixed-input model's prefix embeddings, or an enc-dec model's
    encoder frames (5 of them), as numpy; {} for any other config."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "mixed":
        shape, key = (B, cfg.n_prefix_embeds, cfg.d_model), "prefix_embeds"
    elif cfg.is_encdec:
        shape, key = (B, 5, cfg.d_model), "enc_embeds"
    else:
        return {}
    return {key: rng.standard_normal(shape).astype(np.float32)}


def _losses(loss, jcfg, tcfg, jb, tb):
    """(jax loss of (trained tree, *inputs), port loss, inputs)."""
    if loss == "train":
        return (lambda p, *a, **kw: jax_train_loss(jcfg, p, *a, ce_chunk=4,
                                                   **kw)[0],
                lambda p, *a, **kw: train_loss(tcfg, p, *a, ce_chunk=4,
                                               **kw)[0], _lm())
    if loss == "train-flash":
        return (lambda p, *a: jax_train_loss(jcfg, p, *a, ce_chunk=4,
                                             flash=True)[0],
                lambda p, *a: train_loss(tcfg, p, *a, ce_chunk=4)[0], _lm())
    if loss.startswith("cc"):
        r = float(loss[2:])
        return (lambda p, *a, **kw: jax_cc_loss(jcfg, p, jb, *a,
                                                share_ratio=r, **kw)[0],
                lambda p, *a, **kw: cache_conditioned_loss(
                    tcfg, p, tb, *a, share_ratio=r, **kw)[0],
                _task())
    if loss == "full":
        return (lambda p, *a: jax_full_ft_loss(jcfg, p, *a)[0],
                lambda p, *a: full_ft_loss(tcfg, p, *a)[0], _task())
    return (lambda p, *a: jax_lora_loss(jcfg, p, jb, *a, **LORA)[0],
            lambda p, *a: cache_conditioned_lora_loss(tcfg, p, tb, *a,
                                                      **LORA)[0], _task())


def reference_grad(fn, *args, **kw):
    """``jax.value_and_grad(fn)(*args, **kw)``, jit-compiled at XLA's lowest
    backend optimisation level: the compile is most of these tests' time,
    and the values it gives agree with the default level's to fp32
    rounding (the tolerances below hold either way)."""
    lowered = jax.jit(jax.value_and_grad(fn)).lower(*args, **kw)
    return lowered.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args, **kw)


def _adapters(jb):
    """Reference adapters (A random, B nonzero so every factor gets a
    gradient), and the port's copy."""
    ja = jax_lora_init(jax.random.PRNGKey(5), jb, rank=LORA["rank"])
    ja = jax.tree.map(lambda x: x + 0.05, ja)
    return ja, adapters_from_numpy(jax.tree.map(np.asarray, ja), "cpu")


def _grads(loss, tree):
    """(loss, gradient of every leaf of ``tree``; zeros where unused)."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g
                  for g, x in zip(gs, leaves)]


def _fresh(tree):
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


LOSSES = ("train", "cc1.0", "cc0.5", "cc0.0", "full", "lora")


def check_loss_and_grads(name, loss):
    """The loss and every gradient leaf of the trained tree (the decoder,
    or the adapters for ``lora``) against ``jax.value_and_grad``."""
    jcfg, tcfg = _cfgs(name)
    jb, jd, tb, td = _weights(name)
    jfn, tfn, inputs = _losses(loss, jcfg, tcfg, jb, tb)
    extra = _embeds(tcfg)
    jtree, ttree = (_adapters(jb) if loss == "lora" else (jd, td))
    want_l, want_g = reference_grad(jfn, jtree, *(jnp.asarray(a)
                                                  for a in inputs),
                                    **{k: jnp.asarray(v)
                                       for k, v in extra.items()})
    ttree = _fresh(ttree)
    # train-flash: every attention through the chunked path, forward and
    # remat recompute alike, as the reference's flash=True (the port
    # dispatches by shape only)
    forced = mock.patch.object(attn_mod, "attention", functools.partial(
        attn_mod.attention, force_flash=True))
    with forced if loss == "train-flash" else contextlib.nullcontext():
        got_l, got_g = _grads(tfn(ttree, *(torch.tensor(a) for a in inputs),
                                  **{k: torch.tensor(v)
                                     for k, v in extra.items()}), ttree)
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=RTOL,
                               atol=ATOL)
    want_g = jax.tree.leaves(want_g)
    assert len(got_g) == len(want_g) > 0
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"grad leaf {i}")
    assert sum(float(g.abs().sum()) for g in got_g) > 0


@pytest.mark.parametrize("loss", LOSSES + ("train-flash",))
def test_loss_and_every_grad_leaf_match_reference(loss):
    """tests/test_prefillshare.py's dense config; ``train-flash`` forces
    the chunked attention (``_FlashAttention``) inside the model."""
    check_loss_and_grads("dense", loss)


@pytest.mark.parametrize("loss", ["cc1.0", "cc0.5", "lora"])
def test_base_gets_exactly_zero_gradient(loss):
    """Eq. 7 stops the gradient at C_base (and LoRA merges a detached
    base): d loss / d θ_base is exactly zero even when the base's leaves
    require a gradient (the port's mirror of
    test_gradients_do_not_touch_base / test_lora_grads_only_adapters)."""
    jcfg, tcfg = _cfgs("dense")
    jb, _, tb, td = _weights("dense")
    base = _fresh(tb)
    prompt, ti, to, m = (torch.tensor(a) for a in _task())
    if loss == "lora":
        trained = _fresh(_adapters(jb)[1])
        out = cache_conditioned_lora_loss(tcfg, trained, base, prompt, ti,
                                          to, m, **LORA)[0]
    else:
        trained = _fresh(td)
        out = cache_conditioned_loss(tcfg, trained, base, prompt, ti, to, m,
                                     share_ratio=float(loss[2:]))[0]
    leaves = tree_leaves(base) + tree_leaves(trained)
    gs = torch.autograd.grad(out, leaves, allow_unused=True)
    nb = len(tree_leaves(base))
    assert all(g is None or not g.any() for g in gs[:nb])
    assert sum(float(g.abs().sum()) for g in gs[nb:] if g is not None) > 0


def test_share_mask_matches_reference():
    for n in (1, 3, 4, 26, 32):
        for r in (0.0, 0.1, 0.25, 0.5, 0.51, 0.75, 0.99, 1.0):
            cfg = dict(DENSE, n_layers=n)
            assert _layer_share_mask(TModelConfig(**cfg), r) == \
                jax_share_mask(ModelConfig(**cfg), r)


@functools.lru_cache(maxsize=None)
def _tail_caches():
    """Five layers over a two-layer pattern (two stacked groups and a tail
    layer): configs and the reference's base and self prompt caches."""
    kw = dict(DENSE, n_layers=5, layer_pattern=(ATTN, ATTN))
    jcfg = ModelConfig(**kw)
    prompt = jnp.asarray(_task()[0])
    prefill = jax.jit(lambda p: jax_base_prefill(jcfg, p, prompt,
                                                 cache_len=12)[1])
    return jcfg, TModelConfig(**kw), [
        prefill(jax_init_params(jcfg, jax.random.PRNGKey(s))) for s in (0, 1)]


@pytest.mark.parametrize("ratio", [0.2, 0.5, 0.8])
def test_mix_caches_takes_the_reference_layers_bit_for_bit(ratio):
    """The reference's caches carried across, mixed on each side, equal bit
    for bit; the tail layer is taken whole from one side."""
    jcfg, tcfg, jc = _tail_caches()
    want = jax_mix_caches(jcfg, *jc, ratio)
    tc = [params_from_numpy(jax.tree.map(np.asarray, c), "cpu") for c in jc]
    got = mix_caches(tcfg, *tc, ratio)
    want_l = jax.tree.leaves(want)
    got_l = tree_leaves(got)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    side = 0 if _layer_share_mask(tcfg, ratio)[4] else 1
    assert got["tail"][0]["k"] is tc[side]["tail"][0]["k"]


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_remat_changes_no_value(name):
    """``remat=True`` (each layer-pattern group under
    torch.utils.checkpoint) gives the same loss and gradients."""
    _, tcfg = _cfgs(name)
    _, _, tb, td = _weights(name)
    out = {}
    for remat in (False, True):
        tree = _fresh(td)
        loss = train_loss(tcfg, tree, *(torch.tensor(a) for a in _lm()),
                          ce_chunk=4, remat=remat)[0]
        cc = cache_conditioned_loss(tcfg, tree, tb,
                                    *(torch.tensor(a) for a in _task()),
                                    share_ratio=0.5, remat=remat)[0]
        out[remat] = [_grads(loss, tree), _grads(cc, tree)]
    for (la, ga), (lb, gb) in zip(out[False], out[True]):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["dense", "recurrent"])
def test_functional_cache_path_equals_in_place(name):
    """A prefill into a dense cache: with autograd recording (the decoder's
    leaves require grad) the forward leaves the given cache untouched and
    returns new tensors equal to what serving (no_grad) writes in place,
    and the same logits."""
    _, tcfg = _cfgs(name)
    _, _, _, td = _weights(name)
    toks = torch.tensor(_task()[0])
    cache = init_cache(tcfg, 2, 14, device="cpu")
    blank = tree_map(torch.clone, cache)
    tree = _fresh(td)
    got, new, _ = forward(tcfg, tree, toks, cache=cache)
    assert new is not cache
    for a, b in zip(tree_leaves(cache), tree_leaves(blank)):
        assert torch.equal(a, b)                 # nothing written
    with torch.no_grad():
        want, same, _ = forward(tcfg, td, toks, cache=cache)
    assert same is cache                          # written in place
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    for a, b in zip(tree_leaves(new), tree_leaves(cache)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


def test_recording_forward_refuses_the_paged_pool():
    """The paged pool is only ever written in place, so a forward that
    autograd records over it is refused before any page is touched."""
    from repro_torch.kvcache.paged import PagedKVPool
    _, tcfg = _cfgs("dense")
    _, _, _, td = _weights("dense")
    pool = PagedKVPool(tcfg, num_pages=4, page_size=8, device="cpu")
    cache = pool.make_decode_cache(torch.tensor([[1, 2]], dtype=torch.int32))
    before = [x.clone() for x in pool.layers()[0]]
    with pytest.raises(NotImplementedError, match="paged pool"):
        forward(tcfg, _fresh(td), torch.tensor([[5, 6, 7]]), cache=cache,
                pos=torch.tensor([0], dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(pool.layers()[0], before))


def test_serving_tokens_unchanged_by_training():
    """Greedy serving tokens (``_greedy``: in-place caches, no_grad) are the
    same before and after an Eq. 7 training step run in the same process
    on the same base (the launcher trains a decoder initialised as the
    base), and the base's tensors are bit-unchanged by the step."""
    _, tcfg = _cfgs("dense")
    _, _, tb, _ = _weights("dense")
    prompt = torch.tensor(_task()[0])

    def serve():
        _, cache = base_prefill(tcfg, tb, prompt, cache_len=16)
        return _greedy(tcfg, tb, cache, torch.full((2,), 8, dtype=torch.int32),
                       torch.full((2,), 2, dtype=torch.int32), 6)

    before = serve()
    snapshot = [x.clone() for x in tree_leaves(tb)]
    tr = Trainer(lambda p, **kw: cache_conditioned_loss(tcfg, p, tb, **kw),
                 AdamW(1e-2))
    batch = dict(zip(("prompt", "target_in", "target_out", "target_mask"),
                     (torch.tensor(a) for a in _task(3))))
    dec, _, loss = tr.step(tb, tr.opt.init(tb), batch)
    assert torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tb), snapshot))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(dec),
                                                     snapshot))
    assert not any(x.requires_grad for x in tree_leaves(dec))
    assert torch.equal(serve(), before)
