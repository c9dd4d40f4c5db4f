"""LoRA adapters (repro_torch.core.lora) and LoRA decode groups on the
fused plane, against the reference and against the port's own pre-merged
decoders.

- ``lora_apply`` on adapters carried across from the reference
  (``params.adapters_from_numpy``) against the reference's ``lora_apply``,
  fp32, within 1e-6 (an fp32 rank-4 product summed in another order);
- the fused plane's per-layer lane merge (``lora_lanes``) bit-equal to the
  port's ``lora_apply``, fp32 and bf16;
- analogues of tests/test_lora.py:23, 35, 84 and tests/test_registry.py:289
  (LoRA specs decode like pre-merged ``lora_apply`` decoders, greedy and
  seeded, fp32 and bf16), :324 (mixed full and LoRA groups, two dispatches a
  step) and :351 (lazy per-model materialization); a LoRA group never
  relay-publishes; ``param_bytes`` counts adapter factors only.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.core import lora as RL
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core.lora import (LoRAPair, lora_apply, lora_init,
                                   lora_lanes, lora_param_count,
                                   stack_lora_params)
from repro_torch.models import init_params
from repro_torch.models.model import _layers
from repro_torch.params import (adapters_from_numpy, params_from_numpy,
                                tree_leaves, tree_map)
from repro_torch.serving import (DecodeModelSpec, LocalDisaggEngine,
                                 LoRAAdapter, SamplingParams)

CFG_KW = dict(name="lora-eng", arch_type="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
              dtype="float32")
PAGE = 8


def _ref_adapter_tree(key, base, rank=4):
    """The reference's ``lora_init`` with B made nonzero (as
    tests/test_registry.py::_adapter does), as numpy."""
    tree = RL.lora_init(key, base, rank=rank)
    flat, td = jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: x is None or isinstance(x, RL.LoRAPair))
    out = [None if p is None else
           RL.LoRAPair(p.A, 0.05 * jax.random.normal(
               jax.random.fold_in(key, 77 + i), p.B.shape, p.B.dtype))
           for i, p in enumerate(flat)]
    return jax.tree.map(np.asarray, jax.tree_util.tree_unflatten(td, out))


@pytest.fixture(scope="module")
def ref():
    cfg = ModelConfig(**CFG_KW)
    base = jax_init_params(cfg, jax.random.PRNGKey(0))
    full = jax_init_params(cfg, jax.random.PRNGKey(10))
    ads = [_ref_adapter_tree(jax.random.PRNGKey(100 + i), base)
           for i in range(3)]
    return cfg, base, full, ads


@pytest.fixture(scope="module")
def port(ref):
    _, base, full, ads = ref

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return (TModelConfig(**CFG_KW), bridge(base), bridge(full),
            [adapters_from_numpy(a, device="cpu") for a in ads])


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ======================================================================
# core.lora


def test_lora_apply_matches_reference(ref, port):
    _, jbase, _, jads = ref
    _, base, _, ads = port
    want = RL.lora_apply(jbase, jads[0], alpha=8.0, rank=4)
    got = lora_apply(base, ads[0], alpha=8.0, rank=4)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert isinstance(ads[0]["groups"]["pos0"]["attn"]["wq"], LoRAPair)
    assert ads[0]["groups"]["pos0"]["attn"]["wk"] is None


def test_lora_init_targets_and_identity():
    """tests/test_lora.py:23."""
    cfg = TModelConfig(**{**CFG_KW, "n_layers": 4, "d_model": 128,
                          "n_heads": 4, "n_kv_heads": 4, "d_ff": 384})
    base = init_params(cfg, 0, device="cpu")
    lora = lora_init(base, rank=4,
                     generator=torch.Generator().manual_seed(1))
    n_base = sum(x.numel() for x in tree_leaves(base))
    assert 0 < lora_param_count(lora) < 0.1 * n_base
    merged = lora_apply(base, lora, rank=4)          # B = 0: exact identity
    assert _same(base, merged)
    names = {k for layer in (lora["groups"]["pos0"]["attn"],)
             for k, v in layer.items() if v is not None}
    assert names == {"wq", "wv", "wo"}


def test_real_param_subtree_named_a_b_is_not_an_adapter():
    """tests/test_lora.py:35: classification is positional, never by key
    names."""
    g = torch.Generator().manual_seed(0)
    base = {"wq": torch.randn(8, 8, generator=g),
            "factored": {"A": torch.randn(8, 4, generator=g),
                         "B": torch.randn(4, 8, generator=g)}}
    lora = lora_init(base, rank=2, targets=("wq",),
                     generator=torch.Generator().manual_seed(1))
    assert lora["factored"] == {"A": None, "B": None}
    assert isinstance(lora["wq"], LoRAPair)
    merged = lora_apply(base, lora, rank=2)
    assert merged["factored"]["A"] is base["factored"]["A"]
    assert torch.equal(merged["wq"], base["wq"])
    hot = dict(lora, wq=LoRAPair(lora["wq"].A, torch.ones_like(lora["wq"].B)))
    merged2 = lora_apply(base, hot, rank=2)
    assert not torch.equal(merged2["wq"], base["wq"])
    assert torch.equal(merged2["factored"]["B"], base["factored"]["B"])


def test_stack_lora_params_preserves_none_and_merge(port):
    """tests/test_lora.py:84: stacking keeps None positions, and a stacked
    slice merges exactly like the adapter it came from."""
    _, base, _, ads = port
    stacked = stack_lora_params(ads[:2])
    assert stacked["groups"]["pos0"]["attn"]["wk"] is None
    assert stacked["embed"] is None
    for m in range(2):
        sl = tree_map(lambda x: x[m], stacked)
        assert _same(lora_apply(base, sl, rank=4),
                     lora_apply(base, ads[m], rank=4))
    with pytest.raises(ValueError, match="cannot stack adapters"):
        odd = dict(ads[1], embed=LoRAPair(torch.zeros(64, 4),
                                          torch.zeros(4, 32)))
        stack_lora_params([ads[0], odd])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_lane_merge_bit_equal_to_lora_apply(port, dtype):
    """Each layer's in-step lane weights equal the matching layer of each
    lane's ``lora_apply`` decoder, bit for bit; untargeted weights are the
    base's own tensors."""
    cfg, base, _, ads = port
    base = tree_map(lambda x: x.to(dtype), base)
    ads = [tree_map(lambda x: x.to(dtype), a) for a in ads]
    merged = [lora_apply(base, a, alpha=8.0, rank=4) for a in ads]
    stacked = stack_lora_params(ads)
    per_layer = zip(_layers(cfg, base, None),
                    _layers(cfg, stacked, None, axis=1),
                    *(_layers(cfg, m, None) for m in merged))
    for (lp, _), (ab, _), *lanes in per_layer:
        got = lora_lanes(lp, ab, scale=2.0)
        for name in ("wq", "wv", "wo"):
            assert got["attn"][name].shape[0] == len(ads)
            for m, (lm, _) in enumerate(lanes):
                assert torch.equal(got["attn"][name][m], lm["attn"][name])
        assert got["attn"]["wk"] is lp["attn"]["wk"]
        assert got["mlp"]["wi"] is lp["mlp"]["wi"]


# ======================================================================
# LoRA specs on the engine (tests/test_registry.py)


def _engine(cfg, base, **kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    return LocalDisaggEngine(cfg, base, device="cpu", **kw)


def _ctx(seed, n=19):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 60, n)]


JOBS = [(70, 19, "a0", SamplingParams(max_tokens=6)),
        (71, 13, "a1", SamplingParams(max_tokens=6)),
        (72, 11, "a0", SamplingParams(max_tokens=6, temperature=0.8,
                                      top_k=10, seed=3)),
        (73, 17, "a2", SamplingParams(max_tokens=5, temperature=1.2,
                                      top_p=0.9, seed=4))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_spec_identical_to_materialized(port, dtype):
    """tests/test_registry.py:289: three LoRA models in one fused group
    decode, greedy and seeded, exactly like the same adapters pre-merged
    into full ``lora_apply`` decoders; the LoRA plane stores the adapter
    factors only."""
    cfg, base, _, ads = port
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg = TModelConfig(**{**CFG_KW, "dtype": dtype})
    base = tree_map(lambda x: x.to(tdt), base)
    ads = {f"a{i}": LoRAAdapter(tree_map(lambda x: x.to(tdt), a),
                                alpha=8.0, rank=4) for i, a in enumerate(ads)}
    lora_eng, full_eng = _engine(cfg, base), _engine(cfg, base)
    for mid, ad in ads.items():
        lora_eng.models.register(mid, DecodeModelSpec(lora=ad))
        full_eng.models.register(mid, DecodeModelSpec(full=lora_apply(
            base, ad.params, alpha=ad.alpha, rank=ad.rank)))
    louts = [lora_eng.generate(m, _ctx(s, n), sp) for s, n, m, sp in JOBS]
    fouts = [full_eng.generate(m, _ctx(s, n), sp) for s, n, m, sp in JOBS]
    lora_eng.run()
    full_eng.run()
    for lo, fo in zip(louts, fouts):
        assert lo.tokens == fo.tokens and len(lo.tokens) >= 5
    assert len(lora_eng.decode_plane.groups) == 1
    assert lora_eng.stats.decode_dispatches == lora_eng.stats.decode_steps
    ad_bytes = sum(x.nbytes for x in tree_leaves(ads["a0"].params))
    full_bytes = sum(x.nbytes for x in tree_leaves(
        full_eng.models.get("a0").full))
    assert lora_eng.decode_plane.param_bytes() == 3 * ad_bytes
    assert full_eng.decode_plane.param_bytes() == 3 * full_bytes
    assert lora_eng.decode_plane.groups[0].stacked["base"] is base


def test_mixed_full_and_lora_groups(port):
    """tests/test_registry.py:324: full and LoRA specs form two groups, two
    dispatches a step, each decoding as it would alone."""
    cfg, base, full, ads = port
    ad = LoRAAdapter(ads[0], alpha=8.0, rank=4)
    eng = _engine(cfg, base)
    eng.models.register("full0", DecodeModelSpec(full=full))
    eng.models.register("lora0", DecodeModelSpec(lora=ad))
    o1 = eng.generate("full0", _ctx(80), SamplingParams(max_tokens=5))
    o2 = eng.generate("lora0", _ctx(80), SamplingParams(max_tokens=5))
    eng.run()
    assert len(eng.decode_plane.groups) == 2
    assert eng.stats.decode_dispatches == 2 * eng.stats.decode_steps
    ref_full = _engine(cfg, base)
    ref_full.models.register("full0", full)
    assert o1.tokens == ref_full.generate(
        "full0", _ctx(80), SamplingParams(max_tokens=5)).result().tolist()
    ref_lora = _engine(cfg, base)
    ref_lora.models.register("lora0", DecodeModelSpec(full=lora_apply(
        base, ad.params, alpha=ad.alpha, rank=ad.rank)))
    assert o2.tokens == ref_lora.generate(
        "lora0", _ctx(80), SamplingParams(max_tokens=5)).result().tolist()


def test_lora_per_model_loop_and_lazy_materialization(port):
    """tests/test_registry.py:351: fused=False materializes ``lora_apply``
    lazily and decodes like the fused in-step merge; the fused engine never
    materializes."""
    cfg, base, _, ads = port
    ad = LoRAAdapter(ads[1], alpha=8.0, rank=4)
    fused_eng, loop_eng = _engine(cfg, base), _engine(cfg, base, fused=False)
    for eng in (fused_eng, loop_eng):
        eng.models.register("lm", DecodeModelSpec(lora=ad))
    sp = SamplingParams(max_tokens=6, temperature=0.7, seed=5)
    a = fused_eng.generate("lm", _ctx(90), sp)
    b = loop_eng.generate("lm", _ctx(90), sp)
    c = loop_eng.generate("lm", _ctx(91), SamplingParams(max_tokens=6))
    d = fused_eng.generate("lm", _ctx(91), SamplingParams(max_tokens=6))
    fused_eng.run()
    loop_eng.run()
    assert a.tokens == b.tokens and c.tokens == d.tokens
    assert fused_eng.decoders["lm"]._dec_params is None
    assert loop_eng.decoders["lm"]._dec_params is not None


def test_lora_never_relay_publishes_and_hot_churn(port):
    """A LoRA model's decode-written KV is its own: finished LoRA sequences
    are skipped by relay. A LoRA model registers and unregisters while
    another model is decoding, with pages back to baseline."""
    cfg, base, _, ads = port
    eng = _engine(cfg, base)
    eng.models.register("base", DecodeModelSpec(full=base))
    free0 = eng.block_pool.free_count
    out = eng.generate("base", _ctx(95, 30), SamplingParams(max_tokens=12))
    eng.step()
    eng.models.register("lm", LoRAAdapter(ads[2], alpha=8.0, rank=4))
    lo = eng.generate("lm", _ctx(96, 30), SamplingParams(max_tokens=10))
    eng.run()
    assert eng.decoders["base"].relay_compatible
    assert not eng.decoders["lm"].relay_compatible
    assert eng.stats.relay_skipped == 1 and eng.stats.relay_publishes == 1
    assert out.finished and lo.finished and len(lo.tokens) == 10
    assert eng.models.unregister("lm") is True
    eng.step()
    assert eng.decode_plane.model_ids == ["base"]
    eng.block_pool.check_invariants()
    assert eng.block_pool.active_count == 0
    assert eng.block_pool.free_count == free0    # cached pages count as free


def test_spec_validation_and_adapter_device_check(port):
    cfg, base, full, ads = port
    with pytest.raises(ValueError, match="exactly one"):
        DecodeModelSpec(full=full, lora=LoRAAdapter(ads[0]))
    with pytest.raises(TypeError):
        DecodeModelSpec(lora=ads[0])
    spec = DecodeModelSpec(lora=LoRAAdapter(ads[0], alpha=32.0, rank=16))
    assert spec.kind == "lora" and spec.group_key() == ("lora", 32.0, 16)
    assert LoRAAdapter(ads[0], alpha=32.0, rank=16).scale == 2.0
    eng = _engine(cfg, base)
    meta = tree_map(lambda x: x.to("meta"), ads[0])
    with pytest.raises(ValueError, match="lives on meta"):
        eng.models.register("far", LoRAAdapter(meta))
    top = dict(ads[0], embed=LoRAPair(torch.zeros(64, 4), torch.zeros(4, 32)))
    with pytest.raises(NotImplementedError, match="embed"):
        eng.models.register("emb", LoRAAdapter(top))
    assert "emb" not in eng.models
    _engine(cfg, base, fused=False).models.register("emb", LoRAAdapter(top))


def test_lora_group_with_a_tail_layer_identical_to_materialized():
    """A config whose layers do not divide into its pattern (a stacked
    group plus a tail layer): port-made adapters (nonzero B) on every
    default target decode like their ``lora_apply`` decoders."""
    from repro_torch.configs.base import ATTN
    cfg = TModelConfig(**{**CFG_KW, "n_layers": 3,
                          "layer_pattern": (ATTN, ATTN)})
    base = init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(3)
    ads = {}
    for i in range(2):
        tree = lora_init(base, rank=4, generator=g)
        for node in (tree["tail"][0]["attn"], tree["groups"]["pos1"]["attn"]):
            for k in ("wq", "wv", "wo"):
                node[k] = LoRAPair(node[k].A, 0.05 * torch.randn(
                    node[k].B.shape, generator=g))
        ads[f"t{i}"] = LoRAAdapter(tree, alpha=8.0, rank=4)
    lora_eng, full_eng = _engine(cfg, base), _engine(cfg, base)
    for mid, ad in ads.items():
        lora_eng.models.register(mid, ad)
        full_eng.models.register(mid, lora_apply(base, ad.params, alpha=8.0,
                                                 rank=4))
    jobs = JOBS[:2] + [(74, 21, "t1", SamplingParams(max_tokens=6,
                                                       temperature=0.9,
                                                       seed=8))]
    jobs = [(s, n, f"t{i % 2}", sp) for i, (s, n, _, sp) in enumerate(jobs)]
    got = [lora_eng.generate(m, _ctx(s, n), sp) for s, n, m, sp in jobs]
    want = [full_eng.generate(m, _ctx(s, n), sp) for s, n, m, sp in jobs]
    lora_eng.run()
    full_eng.run()
    assert [o.tokens for o in got] == [o.tokens for o in want]
