"""The port's engine against the reference engine, on carried-across weights.

Each scenario mirrors a reference test; the reference engine runs it once
(module-scoped fixtures), the port runs it on the CPU with the kernels'
plain versions, and the greedy tokens must be identical:
  - tests/test_paged_engine.py::test_paged_matches_dense_engine_bitwise
    (two turns x two agents over a growing context, copy-on-write tails);
  - tests/test_fused_decode.py::test_fused_matches_per_model_loop_bitwise
    (fused plane against fused=False, ragged mixed-model batches) and the
    one-dispatch-per-step contract;
  - relay against relay=False (tokens identical; pages are not compared,
    see ROADMAP.md Queue 3);
  - tests/test_fused_decode.py::test_sentinel_page_zero_never_holds_live_kv
    (a ragged fused batch writes nothing into pool row 0).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ATTN, ModelConfig
from repro.models import init_params as jax_init_params
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.params import params_from_numpy
from repro_torch.serving import LocalDisaggEngine, SamplingParams

BASE = dict(arch_type="dense", d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
            vocab_size=64, dtype="float32")
CFGS = {"grouped": dict(name="paged-eng", n_layers=2),
        "with-tail": dict(name="fused-tail", n_layers=3,
                          layer_pattern=(ATTN, ATTN))}
PAGE = 8


def _setup(name, n_models):
    kw = {**BASE, **CFGS[name]}
    jcfg, tcfg = ModelConfig(**kw), TModelConfig(**kw)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdecs = {f"m{i}": jax_init_params(jcfg, jax.random.PRNGKey(10 + i))
             for i in range(n_models)}

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")

    return (jcfg, jbase, jdecs), (tcfg, bridge(jbase),
                                  {m: bridge(p) for m, p in jdecs.items()})


def _port(tcfg, base, decs=None, **kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    return LocalDisaggEngine(tcfg, base, decs, device="cpu", **kw)


def _tok(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(4, 60, n)]


# ======================================================================
# two turns x two agents (test_paged_engine.py)


def _two_turn_jobs():
    rng = np.random.default_rng(0)
    ctx = list(rng.integers(4, 60, size=19))      # off a page boundary
    return ctx, [list(rng.integers(4, 60, size=5)) for _ in range(4)]


@pytest.fixture(scope="module")
def two_turn():
    (jcfg, jbase, jdecs), port = _setup("grouped", 2)
    ref = JaxEngine(jcfg, jbase, jdecs, num_pages=64, page_size=PAGE)
    ctx, adds = _two_turn_jobs()
    outs = []
    for i, add in enumerate(adds):
        ctx = ctx + add
        got = ref.invoke(0, ctx, f"m{i % 2}", gen_tokens=4)
        outs.append([int(t) for t in got])
        ctx = ctx + outs[-1]
    return port, outs


def test_two_turns_two_agents_match_reference(two_turn):
    (tcfg, base, decs), want = two_turn
    eng = _port(tcfg, base, decs)
    ctx, adds = _two_turn_jobs()
    got = []
    for i, add in enumerate(adds):
        ctx = ctx + add
        out = eng.generate(f"m{i % 2}", ctx, SamplingParams(max_tokens=4),
                           session=0).result()
        got.append([int(t) for t in out])
        ctx = ctx + got[-1]
    assert got == want
    assert eng.stats.prefill_tokens_reused > 0
    assert eng.stats.cow_page_copies > 0          # partial tails were cloned


# ======================================================================
# fused plane vs per-model loop (test_fused_decode.py)


def _mixed_workload(n_models):
    """Ragged contexts, staggered lengths: m0 finishes first, so later steps
    run with a model at zero active sequences."""
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(2 * n_models):
        mid = f"m{i % n_models}"
        ctx = list(rng.integers(4, 60, size=11 + 5 * i))
        jobs.append((i, ctx, mid, 3 if mid == "m0" else 6 + (i % 2)))
    return jobs


def _run_port(eng, jobs):
    outs = [eng.generate(mid, ctx, SamplingParams(max_tokens=gen),
                         session=sid) for sid, ctx, mid, gen in jobs]
    eng.run()
    return [[int(t) for t in o.tokens] for o in outs]


@pytest.fixture(scope="module", params=sorted(CFGS))
def fused_case(request):
    (jcfg, jbase, jdecs), port = _setup(request.param, 3)
    ref = JaxEngine(jcfg, jbase, jdecs, num_pages=64, page_size=PAGE)
    jobs = _mixed_workload(3)
    rids = [ref.submit(sid, ctx, mid, gen) for sid, ctx, mid, gen in jobs]
    ref.run()
    return port, jobs, [[int(t) for t in ref.result(r)] for r in rids]


def test_fused_and_per_model_loop_match_reference(fused_case):
    (tcfg, base, decs), jobs, want = fused_case
    fused = _port(tcfg, base, decs)
    legacy = _port(tcfg, base, decs, fused=False)
    assert fused.decode_plane is not None and legacy.decode_plane is None
    assert _run_port(fused, jobs) == want
    assert _run_port(legacy, jobs) == want
    assert fused.stats.decode_tokens == legacy.stats.decode_tokens
    assert fused.stats.decode_batch_mean > 1.0


def test_one_dispatch_per_step_across_models(fused_case):
    (tcfg, base, decs), _, _ = fused_case
    jobs = [(sid, _tok(sid, 12 + sid), f"m{sid}", 5) for sid in range(3)]
    fused = _port(tcfg, base, decs)
    _run_port(fused, jobs)
    assert fused.stats.decode_dispatches == fused.stats.decode_steps
    assert fused.decode_plane.dispatches == fused.stats.decode_steps
    legacy = _port(tcfg, base, decs, fused=False)
    _run_port(legacy, jobs)
    # all three models active on every step -> 3x the fused dispatches
    assert legacy.stats.decode_dispatches == 3 * fused.stats.decode_steps


# ======================================================================
# relay vs relay=False (test_relay.py chain)

PROMPT = list(range(1, 21))                      # 2 full pages + a 4-token tail


def _chain(eng, params_cls):
    a_out = [int(t) for t in eng.generate(
        "a", PROMPT, params_cls(max_tokens=12)).result()]
    b_prompt = PROMPT + [2] + a_out
    b_out = [int(t) for t in eng.generate(
        "b", b_prompt, params_cls(max_tokens=6)).result()]
    return a_out, b_out


@pytest.fixture(scope="module")
def relay_ref():
    (jcfg, jbase, _), (tcfg, base, _) = _setup("grouped", 0)
    ref = JaxEngine(jcfg, jbase, num_pages=64, page_size=PAGE)
    ref.models.register("a", jbase)
    ref.models.register("b", jbase)
    return (tcfg, base), _chain(ref, JSamplingParams)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-model"])
def test_relay_chain_matches_relay_off_and_reference(relay_ref, fused):
    (tcfg, base), want = relay_ref
    runs = {}
    for relay in (True, False):
        eng = _port(tcfg, base, relay=relay, fused=fused)
        eng.models.register("a", base)
        eng.models.register("b", base)
        runs[relay] = _chain(eng, SamplingParams)
        s = eng.stats()
        if relay:
            assert s["relay_publishes"] >= 1 and s["relay_hit_tokens"] > 0
        else:
            assert s["relay_publishes"] == 0 and s["relay_hit_tokens"] == 0
        assert eng.block_pool.active_count == 0
        eng.block_pool.check_invariants()
    assert runs[True] == runs[False] == want


def test_relay_chain_chunked_matches_reference(relay_ref):
    """The relay chain under chunked prefill: the second prompt's prefix is
    served from relay-published (decode-written) pages and its chunks
    attend to them straight from the pool, with the reference's tokens."""
    (tcfg, base), want = relay_ref
    eng = _port(tcfg, base, chunked=True, chunk_size=5, token_budget=16)
    eng.models.register("a", base)
    eng.models.register("b", base)
    assert _chain(eng, SamplingParams) == want
    s = eng.stats()
    assert s["relay_publishes"] >= 1 and s["relay_hit_tokens"] > 0
    assert eng.scheduler.stats.chunks > 1
    assert eng.block_pool.active_count == 0
    eng.block_pool.check_invariants()


# ======================================================================
# page accounting and device selection


def test_pages_back_to_baseline_after_end_session_and_abort(two_turn):
    (tcfg, base, decs), _ = two_turn
    eng = _port(tcfg, base, decs)
    free0 = eng.block_pool.free_count
    with eng.shared_context(_tok(1, 21)) as ctx:
        done = ctx.generate("m0", _tok(2, 3), SamplingParams(max_tokens=4))
        live = ctx.generate("m1", _tok(3, 5), SamplingParams(max_tokens=30))
        eng.step()
        eng.step()
        assert eng.abort(live) and live.finish_reason == "abort"
        assert not eng.abort(live)                       # already aborted
        done.result()
        assert not eng.abort(done)                       # already finished
    assert eng.block_pool.active_count == 0
    assert eng.block_pool.free_count == free0
    eng.block_pool.check_invariants()


def test_sentinel_page_zero_never_holds_live_kv(two_turn):
    """tests/test_fused_decode.py's sentinel regression: page id 0 is never
    allocated, and pool row 0 receives no write, on any layer. A ragged mix
    (two m0 sequences, one m1) gives the fused (M=2, Bmax=2) grid a padding
    row, whose block table is all sentinel; it must write nothing, and the
    batch must decode exactly like isolated runs."""
    from repro_torch.kvcache.blocks import BlockPool
    pool = BlockPool(4, PAGE)
    got = pool.alloc(4)                              # drain the whole pool
    assert 0 not in got and min(got) == 1
    with pytest.raises(ValueError, match="sentinel"):
        pool.ref([0])
    with pytest.raises(ValueError, match="sentinel"):
        pool.drop([0])
    pool.check_invariants()

    (tcfg, base, decs), _ = two_turn
    rng = np.random.default_rng(3)
    jobs = [(list(rng.integers(4, 60, size=n)), m)
            for n, m in ((37, "m0"), (9, "m0"), (20, "m1"))]
    eng = _port(tcfg, base, decs)
    outs = [eng.generate(m, ctx, SamplingParams(max_tokens=5), session=sid)
            for sid, (ctx, m) in enumerate(jobs)]
    steps = []
    plane = eng.decode_plane.groups[0]
    orig = plane.step
    plane.step = lambda seqs: steps.append(len(seqs)) or orig(seqs)
    eng.run()
    assert steps and all(n == 3 for n in steps)      # one padding row each
    used = {p for w in eng.prefill_workers for sc in w.sessions.values()
            for p in sc.block_table}
    assert 0 not in used
    kv = eng.kvpool
    for a in (*kv.k_groups.values(), *kv.v_groups.values()):
        assert not a[:, 0].any(), "a group layer wrote sentinel row 0"
    for a in (*kv.k_tail, *kv.v_tail):
        assert not a[0].any(), "a tail layer wrote sentinel row 0"
    alone = [_port(tcfg, base, decs).generate(
        m, ctx, SamplingParams(max_tokens=5)).result().tolist()
        for ctx, m in jobs]
    assert [o.tokens for o in outs] == alone


def test_engine_without_device_raises_when_no_card(two_turn, monkeypatch):
    (tcfg, base, decs), _ = two_turn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalDisaggEngine(tcfg, base, decs)


def test_hot_register_and_unregister_while_decoding(two_turn):
    """Registry churn at step boundaries: a model registered mid-run joins
    the fused plane at the next step; unregister(drain=False) aborts its
    live requests; unregister(drain=True) waits for them; pages return to
    baseline."""
    (tcfg, base, decs), _ = two_turn
    eng = _port(tcfg, base, {"m0": decs["m0"]})
    free0 = eng.block_pool.free_count
    a = eng.generate("m0", _tok(4, 13), SamplingParams(max_tokens=6))
    eng.step()
    eng.models.register("m1", decs["m1"])
    b = eng.generate("m1", _tok(5, 11), SamplingParams(max_tokens=6))
    eng.step()                                     # rebuilds, then decodes
    assert eng.stats.plane_rebuilds == 1
    assert eng.decode_plane.model_ids == ["m0", "m1"]
    assert eng.models.unregister("m1", drain=False)       # aborts b
    assert b.finish_reason == "abort"
    assert not eng.models.unregister("m0", drain=True)    # a still decoding
    assert "m0" in eng.models.draining
    with pytest.raises(Exception, match="draining"):
        eng.generate("m0", _tok(6, 9))
    eng.run()
    assert a.finish_reason == "length" and len(a.tokens) == 6
    eng.step()                                     # boundary: drain finalizes
    assert len(eng.models) == 0
    assert eng.block_pool.free_count == free0


# ======================================================================
# the fused plane's weight layout (core/lora.py)


def _stacked_case(n_models):
    from repro_torch.core.lora import unstack_params
    from repro_torch.models import init_params, init_stacked_params
    tcfg = TModelConfig(**{**BASE, **CFGS["with-tail"]})
    base = init_params(tcfg, 0, device="cpu")
    seeds = [1 + m for m in range(n_models)]
    stacked = init_stacked_params(tcfg, seeds, device="cpu")
    return tcfg, base, stacked, unstack_params(stacked, n_models), seeds


def _plane_leaves(eng):
    from repro_torch.params import tree_leaves
    (group,) = eng.decode_plane.groups
    return tree_leaves(group.stacked)


def test_stacked_built_decoders_serve_without_a_copy():
    """Rows of one init_stacked_params tree, registered under names whose
    sorted order is not their row order, are served as a view of that tree
    (also after a churn that leaves an end row), with the tokens of the same
    decoders built one by one."""
    from repro_torch.models import init_params
    from repro_torch.params import tree_leaves
    tcfg, base, stacked, (row0, row1), seeds = _stacked_case(2)
    eng = _port(tcfg, base, {"zeta": row0, "alpha": row1})
    assert eng.decode_plane.groups[0].model_ids == ["zeta", "alpha"]
    ptrs = [x.data_ptr() for x in tree_leaves(stacked)]
    assert [x.data_ptr() for x in _plane_leaves(eng)] == ptrs
    own = _port(tcfg, base, {"zeta": init_params(tcfg, seeds[0], device="cpu"),
                             "alpha": init_params(tcfg, seeds[1],
                                                  device="cpu")})
    outs = {}
    for name, e in (("views", eng), ("own", own)):
        with e.shared_context(_tok(7, 19)) as ctx:
            reqs = [ctx.generate(m, _tok(8 + i, 4), SamplingParams(max_tokens=5))
                    for i, m in enumerate(("alpha", "zeta", "alpha"))]
            outs[name] = [r.result().tolist() for r in reqs]
    assert outs["views"] == outs["own"]
    from repro_torch.launch.main_path import resident_bytes
    kv = eng.kvpool
    held = tree_leaves(base) + tree_leaves(stacked) + [
        *kv.k_groups.values(), *kv.v_groups.values(), *kv.k_tail, *kv.v_tail]
    assert resident_bytes(eng) == sum(x.numel() * x.element_size()
                                      for x in held)
    assert eng.models.unregister("zeta")
    eng.models.sync()
    row_bytes = tree_leaves(stacked)[0][0].numel() * 4
    assert _plane_leaves(eng)[0].data_ptr() == ptrs[0] + row_bytes


def test_stacking_that_would_copy_stacked_rows_is_refused():
    """Rows of a stacked tree that are not consecutive rows of one tree, or
    that are mixed with a tree built on its own, would be copied beside the
    tree they keep alive: registry changes that need it raise before any
    state changes (the per-model loop, which stacks nothing, accepts
    them)."""
    from repro_torch.models import init_params
    tcfg, base, _, (row0, row1, row2), _ = _stacked_case(3)
    with pytest.raises(ValueError, match="consecutive rows"):
        _port(tcfg, base, {"a": row0, "c": row2})
    eng = _port(tcfg, base, {"a": row0, "b": row1, "c": row2})
    with pytest.raises(ValueError, match="consecutive rows"):
        eng.models.register("own", init_params(tcfg, 9, device="cpu"))
    with pytest.raises(ValueError, match="consecutive rows"):
        eng.models.unregister("b")
    assert eng.models.list() == ["a", "b", "c"] and not eng.models.draining
    assert eng.models.unregister("c")
    eng.models.sync()
    assert eng.decode_plane.model_ids == ["a", "b"]
    _port(tcfg, base, {"a": row0, "c": row2}, fused=False)
    # the constructor stacks its whole set once, in any registration order
    eng = _port(tcfg, base, {"c": row2, "a": row0, "b": row1})
    assert eng.decode_plane.model_ids == ["a", "b", "c"]


# ======================================================================
# sampling and LoRA groups against the reference engine


# one decode composition and one table-width bucket from the first decode
# step to the last, so the reference compiles its steps once
SAMPLED_JOBS = [
    (11, 19, "m0", dict(max_tokens=6, temperature=0.8, top_k=12, seed=7)),
    (12, 17, "m1", dict(max_tokens=6, temperature=1.3, seed=3)),
    (13, 22, "m0", dict(max_tokens=6)),
    (14, 20, "m1", dict(max_tokens=6, temperature=0.7, top_k=20, top_p=0.9,
                        seed=2**31 - 1))]
ENGINE_MODES = {"fused": {}, "per-model": {"fused": False},
                "chunked": {"chunked": True, "chunk_size": 5,
                            "token_budget": 16}}


def _serve(eng, jobs, params_cls):
    outs = [eng.generate(mid, _tok(s, n), params_cls(**kw))
            for s, n, mid, kw in jobs]
    eng.run()
    return [[int(t) for t in o.tokens] for o in outs]


@pytest.fixture(scope="module", params=sorted(ENGINE_MODES))
def sampled_case(request):
    (jcfg, jbase, jdecs), port = _setup("grouped", 2)
    ref = JaxEngine(jcfg, jbase, jdecs, num_pages=64, page_size=PAGE,
                    **ENGINE_MODES[request.param])
    return request.param, port, _serve(ref, SAMPLED_JOBS, JSamplingParams)


def test_seeded_sampled_serve_matches_reference(sampled_case):
    """Seeded sampled requests (top_k, top_p, both, neither) packed with a
    greedy one across two models: the reference engine's tokens, fused,
    per-model and chunked."""
    mode, (tcfg, base, decs), want = sampled_case
    eng = _port(tcfg, base, decs, **ENGINE_MODES[mode])
    assert _serve(eng, SAMPLED_JOBS, SamplingParams) == want


def _ref_lora(key, base, rank=4, alpha=8.0):
    """tests/test_registry.py::_adapter: lora_init with nonzero B."""
    from repro.core.lora import LoRAPair, lora_init
    from repro.serving.registry import LoRAAdapter as JLoRAAdapter
    tree = lora_init(key, base, rank=rank)
    flat, td = jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: x is None or isinstance(x, LoRAPair))
    out = [None if p is None else
           LoRAPair(p.A, 0.05 * jax.random.normal(
               jax.random.fold_in(key, 77 + i), p.B.shape, p.B.dtype))
           for i, p in enumerate(flat)]
    return JLoRAAdapter(jax.tree_util.tree_unflatten(td, out), alpha=alpha,
                        rank=rank)


LORA_JOBS = [(s, n, f"a{i % 2}", kw) for i, (s, n, _, kw)
             in enumerate(SAMPLED_JOBS[:3])]


@pytest.fixture(scope="module")
def lora_case():
    from repro.serving.registry import DecodeModelSpec as JSpec
    (jcfg, jbase, _), (tcfg, base, _) = _setup("grouped", 0)
    ads = {f"a{i}": _ref_lora(jax.random.PRNGKey(100 + i), jbase)
           for i in range(2)}
    ref = JaxEngine(jcfg, jbase, num_pages=64, page_size=PAGE)
    for mid, ad in ads.items():
        ref.models.register(mid, JSpec(lora=ad))
    want = _serve(ref, LORA_JOBS, JSamplingParams)
    return (tcfg, base), ads, want


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-model"])
def test_lora_group_serve_matches_reference(lora_case, fused):
    """Two LoRA decode models (adapters carried across), greedy and seeded:
    the reference engine's tokens, from the fused in-step merge and from
    the lazily materialized per-model path."""
    from repro_torch.params import adapters_from_numpy
    from repro_torch.serving import DecodeModelSpec, LoRAAdapter
    (tcfg, base), ads, want = lora_case
    eng = _port(tcfg, base, fused=fused)
    for mid, ad in ads.items():
        eng.models.register(mid, DecodeModelSpec(lora=LoRAAdapter(
            adapters_from_numpy(jax.tree.map(np.asarray, ad.params),
                                device="cpu"), alpha=ad.alpha,
            rank=ad.rank)))
    assert _serve(eng, LORA_JOBS, SamplingParams) == want
    if fused:
        assert eng.stats.decode_dispatches == eng.stats.decode_steps
    assert eng.stats.relay_publishes == 0
    assert eng.stats.relay_skipped == len(LORA_JOBS)
