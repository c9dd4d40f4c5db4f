"""The port's step builders (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), one reduced config per family on tiny
input shapes registered as the reference's own test registers ``tiny_dec``.

- ``build``'s arguments: the same shapes and dtypes, leaf for leaf, as the
  reference ``build``'s ``ShapeDtypeStruct``s on a one-device host mesh;
- the serve and prefill steps on ``materialize``d arguments, the weights
  drawn once from a seed by the port's ``init_params`` and handed to the
  reference as the same numbers (the reference's eager init costs seconds
  per family): logits and the written cache within fp32 tolerance (2e-5
  absolute and relative) of the reference's step functions, compiled, on
  the same inputs;
- one train step (dense only: each reference ``value_and_grad`` compile
  costs tier-1 time): the loss within 1e-5 relative, the parameters held
  to the bound of tests/test_torch_training.py (99.9% of elements within
  1e-5, all within 1e-4), updated in place.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import InputShape as RefShape
from repro.configs.base import get_config as ref_config
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.training import optim as ref_optim
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.params import tree_leaves, tree_map

FAMILIES = ["internlm2-1.8b",          # dense
            "granite-moe-3b-a800m",    # MoE
            "mamba2-780m",             # SSM
            "recurrentgemma-2b",       # hybrid (RG-LRU + local attention)
            "seamless-m4t-medium",     # enc-dec
            "internvl2-76b"]           # mixed input
SHAPES = {"tiny_train": "train", "tiny_pre": "prefill", "tiny_dec": "decode"}
#: the parity cases' width
SMALL = dict(d_model=64, vocab=128)


@pytest.fixture(scope="module", autouse=True)
def tiny_shapes():
    for name, kind in SHAPES.items():
        REF_SHAPES[name] = RefShape(name, 16, 2, kind)
        INPUT_SHAPES[name] = InputShape(name, 16, 2, kind)
    yield
    for name in SHAPES:
        REF_SHAPES.pop(name)
        INPUT_SHAPES.pop(name)


def ref_build(cfg, shape):
    """The reference's build on a one-device host mesh, its models'
    sharding hooks put back to None after (build sets them)."""
    try:
        return ref_steps.build(cfg, shape, jax.make_mesh((1, 1),
                                                         ("data", "model")))
    finally:
        ref_model.ACTIVATION_SPEC = None
        ref_attn.FLASH_KV_SPEC = None


def leaves(tree):
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_build_arguments_match_reference(arch, shape):
    got = steps.build(get_config(arch).reduced(), shape)
    want = ref_build(ref_config(arch).reduced(), shape)
    assert leaves(got["args"]) == [(tuple(x.shape), str(x.dtype))
                                   for x in jax.tree.leaves(want["args"])]
    assert all(t.device.type == "meta" for t in tree_leaves(got["args"]))
    assert got["placements"] is None
    assert got["donate"] == want["donate"]


def to_jax(tree):
    """Copies (jax may alias a numpy buffer, which the port's step then
    writes in place)."""
    def one(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:           # numpy has no bf16
            return jnp.array(t.float().numpy(), jnp.bfloat16)
        return jnp.array(t.numpy(), copy=True)
    return tree_map(one, tree)


@functools.lru_cache(maxsize=None)
def bridged(arch, **kw):
    """(port cfg, reference cfg, port params from seed 1) at
    ``reduced(**SMALL, **kw)``; the serving steps never write the params,
    so cases share them."""
    cfg = get_config(arch).reduced(**SMALL, **kw)
    return (cfg, ref_config(arch).reduced(**SMALL, **kw),
            init_params(cfg, seed=1, device="cpu"))


@pytest.mark.parametrize("shape", ["tiny_pre", "tiny_dec"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_steps_match_reference(arch, shape):
    cfg, rcfg, params = bridged(arch)
    args = steps.materialize(cfg, shape, "cpu", params=params, seed=3)
    b = steps.build(cfg, shape)
    assert steps.arg_bytes(args) == steps.arg_bytes(b["args"])
    ref_args = to_jax(args)            # before the step writes the cache
    make = (ref_steps.make_prefill_step if shape == "tiny_pre"
            else ref_steps.make_serve_step)
    want_logits, want_cache = jax.block_until_ready(
        jax.jit(make(rcfg))(*ref_args))
    logits, cache = b["fn"](*args)
    assert cache is args[2]                            # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=2e-5, atol=2e-5)
    for got, want in zip(tree_leaves(cache), jax.tree.leaves(want_cache)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_train_step_matches_reference():
    cfg, rcfg, params = bridged("internlm2-1.8b")
    params = tree_map(torch.clone, params)     # the step writes them
    args = steps.materialize(cfg, "tiny_train", "cpu", params=params, seed=4)
    ref_args = to_jax(args)
    ref_args = (ref_args[0], ref_optim.AdamWState(*ref_args[1]), ref_args[2])
    b = steps.build(cfg, "tiny_train")
    assert b["donate"] == (0, 1)
    want_p, want_s, want_loss = jax.block_until_ready(
        ref_build(rcfg, "tiny_train")["fn"](*ref_args))
    before = [t.clone() for t in tree_leaves(args[0])]
    got_p, got_s, loss = b["fn"](*args)
    assert got_p is args[0] and got_s is args[1]       # updated in place
    assert not all(torch.equal(a, t) for a, t in zip(before,
                                                     tree_leaves(got_p)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert int(got_s.step) == int(want_s.step) == 1
    got = np.concatenate([t.float().numpy().ravel()
                          for t in tree_leaves(got_p)])
    want = np.concatenate([np.asarray(t, np.float32).ravel()
                           for t in jax.tree.leaves(want_p)])
    close = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_param_shapes_draw_nothing():
    """The shape-only tree is the reference's eval_shape, on the meta
    device, for a full-size config (nothing is allocated)."""
    for arch in ("grok-1-314b", "internlm2-1.8b"):
        got = steps.param_structs(get_config(arch))
        want = ref_steps.param_structs(ref_config(arch))
        assert leaves(got) == [(tuple(x.shape), str(x.dtype))
                               for x in jax.tree.leaves(want)]
        assert {t.device.type for t in tree_leaves(got)} == {"meta"}
