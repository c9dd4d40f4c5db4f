"""The dense half of the port's cache handoff against the reference's
(tests/test_handoff_quant.py's analogue):

- ``quantize_cache`` on a dense cache the reference's ``base_prefill``
  built (KV of global and sliding-window layers, SSD and RG-LRU states,
  fp32 and bf16): the int8 payload and the fp32 scales equal the
  reference's bit for bit (round half to even), ``dequantize_cache`` equals
  the reference's, and ``quantized_bytes`` too; the round trip keeps every
  leaf's shape and dtype, within 2% of each leaf's range;
- decode quality from a quantized cache: logits within 5e-2 of the fp32
  cache's, the same argmax;
- ``HandoffChannel.plan``'s bytes equal the reference's ``plan(n).bytes``
  for every assigned arch (on the H100's NVLink default too), and its
  seconds and staging equal the reference's under the same link settings;
- ``transfer_cache`` copies: the copy does not alias the original.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as jget
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.prefillshare import base_prefill as jbase_prefill
from repro.kvcache import handoff as JH
from repro.models import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import base_prefill
from repro_torch.kvcache import handoff as TH
from repro_torch.models import forward, init_params
from repro_torch.params import params_from_numpy, tree_leaves

CFG_KW = dict(name="hq", arch_type="dense", n_layers=3, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
              dtype="float32")


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _ref_cache(name, dtype):
    """A dense cache built by the reference's base_prefill over 24 tokens:
    the toy config (global KV) or an assigned arch at reduced width."""
    if name == "toy":
        jcfg = JModelConfig(**dict(CFG_KW, dtype=dtype))
    else:
        jcfg = dataclasses.replace(jget(name).reduced(d_model=64, vocab=64),
                                   dtype=dtype)
    base = jinit(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 4, 60)
    _, cache = jbase_prefill(jcfg, base, toks, cache_len=32)
    return cache


CACHES = [("toy", "float32"), ("toy", "bfloat16"),
          ("gemma2-27b", "float32"), ("recurrentgemma-2b", "bfloat16"),
          ("mamba2-780m", "float32")]


@pytest.mark.parametrize("name,dtype", CACHES)
def test_quantize_equals_reference_bit_for_bit(name, dtype):
    jc = _ref_cache(name, dtype)
    tc = _to_torch(jc)
    jq, tq = JH.quantize_cache(jc), TH.quantize_cache(tc)
    jl = jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, dict)
                         and set(x) == {"q", "scale", "dtype"})
    tl = _q_leaves(tq)
    assert len(jl) == len(tl)
    n_q = 0
    for a, b in zip(jl, tl):
        if isinstance(a, dict):
            n_q += 1
            assert b["dtype"] == a["dtype"]
            assert b["q"].dtype == torch.int8
            np.testing.assert_array_equal(b["q"].numpy(), np.asarray(a["q"]))
            np.testing.assert_array_equal(b["scale"].numpy(),
                                          np.asarray(a["scale"]))
        else:
            np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert n_q > 0
    jd, td = JH.dequantize_cache(jq), TH.dequantize_cache(tq)
    for a, b in zip(jax.tree.leaves(jd), tree_leaves(td)):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
        np.testing.assert_array_equal(_np(b), np.asarray(a).astype(
            np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a))
    assert TH.quantized_bytes(tc) == JH.quantized_bytes(jc)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _q_leaves(tree):
    """Leaves in ``jax.tree.leaves``' order, a quantized leaf's dict as one
    leaf."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale", "dtype"}:
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _q_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _q_leaves(t)]
    return [tree]


def test_round_trip_keeps_structure_and_halves_bytes():
    cfg = ModelConfig(**CFG_KW)
    base = init_params(cfg, 0, device="cpu")
    toks = torch.randint(4, 60, (2, 24), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    _, cache = base_prefill(cfg, base, toks, cache_len=32)
    dq = TH.dequantize_cache(TH.quantize_cache(cache))
    for a, b in zip(tree_leaves(cache), tree_leaves(dq)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point() and a.dim() >= 3:
            scale = float(a.abs().max()) + 1e-9
            assert float((a - b).abs().max()) / scale < 0.02
    fp_bytes = sum(x.nbytes for x in tree_leaves(cache)
                   if x.is_floating_point() and x.dim() >= 3)
    assert TH.quantized_bytes(cache) < 0.45 * fp_bytes + 4096


def test_decode_quality_from_quantized_cache():
    cfg = ModelConfig(**CFG_KW)
    base = init_params(cfg, 0, device="cpu")
    dec = init_params(cfg, 2, device="cpu")
    toks = torch.randint(4, 60, (2, 24), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    _, cache = base_prefill(cfg, base, toks, cache_len=32)
    cache_q = TH.dequantize_cache(TH.quantize_cache(cache))
    pos = torch.full((2,), 24, dtype=torch.int32)
    nxt = torch.full((2, 1), 2, dtype=torch.int32)
    lo_fp, _, _ = forward(cfg, dec, nxt, cache=TH.transfer_cache(cache),
                          pos=pos)
    lo_q, _, _ = forward(cfg, dec, nxt, cache=cache_q, pos=pos)
    assert float((lo_fp - lo_q).abs().max()) < 5e-2
    assert torch.equal(lo_fp.argmax(-1), lo_q.argmax(-1))


@pytest.mark.parametrize("name", ASSIGNED)
def test_plan_equals_reference(name):
    """Bytes always; seconds and staging under the same link settings."""
    link = dict(link_gbps=50.0, n_links=4, staging_penalty=4.0)
    jch = JH.HandoffChannel(jget(name), **link)
    tch = TH.HandoffChannel(tget(name), **link)
    h100 = TH.HandoffChannel(tget(name))
    for n in (0, 37, 1000):
        want = jch.plan(n)
        assert h100.plan(n).bytes == want.bytes
        assert tch.plan(n) == TH.HandoffPlan(want.bytes, want.seconds,
                                             want.staged)
        for free in (-1, 0, want.bytes - 1, want.bytes, 10 * want.bytes):
            want = jch.plan(n, decode_hbm_free_bytes=free)
            got = tch.plan(n, decode_hbm_free_bytes=free)
            assert (got.bytes, got.seconds, got.staged) == \
                (want.bytes, want.seconds, want.staged)


def test_transfer_cache_copies():
    cache = {"groups": {"pos0": {"k": torch.ones(2, 1, 4, 8)}},
             "tail": [{"h": torch.zeros(1, 8)}]}
    copy = TH.transfer_cache(cache)
    copy["groups"]["pos0"]["k"].add_(1.0)
    assert float(cache["groups"]["pos0"]["k"].max()) == 1.0
    moved = TH.transfer_cache(cache, "cpu")
    assert moved["tail"][0]["h"].device.type == "cpu"
