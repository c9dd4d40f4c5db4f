"""The port's pool sanitizer: ``sanitize=True`` gives the tokens of
``sanitize=False`` (and of the reference), and every seeded corruption of
tests/test_sanitizer.py trips with its diagnostic, on the CPU.

The reference's donation-poisoning cases (``SanitizedKVPool``) have no
counterpart: the port updates its pool in place and donates nothing
(``repro_torch/kvcache/sanitize.py``).
"""
import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.kvcache.blocks import BlockPool as JaxBlockPool
from repro.kvcache.radix import Node as JaxNode
from repro.kvcache.radix import PrefixIndex as JaxPrefixIndex
from repro.kvcache.sanitize import SanitizerError as JaxSanitizerError
from repro.kvcache.sanitize import check_index as jax_check_index
from repro.kvcache.sanitize import check_pool as jax_check_pool
from repro.models import init_params as jax_init_params
from repro.serving.api import SamplingParams as JaxSamplingParams
from repro.serving.engine import LocalDisaggEngine as JaxEngine
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kvcache import (BlockPool, PrefixIndex, SanitizerError,
                                 check_index, check_pool)
from repro_torch.kvcache.radix import Node
from repro_torch.params import params_from_numpy
from repro_torch.serving import LocalDisaggEngine, SamplingParams

KW = dict(name="sanitize-eng", arch_type="dense", n_layers=2, d_model=32,
          n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32")
PAGE = 8


@pytest.fixture(scope="module")
def weights():
    jcfg = ModelConfig(**KW)
    jbase = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jdecs = {f"m{i}": jax_init_params(jcfg, jax.random.PRNGKey(10 + i))
             for i in range(2)}

    def bridge(p):
        return params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")

    return ((jcfg, jbase, jdecs),
            (TModelConfig(**KW), bridge(jbase),
             {m: bridge(p) for m, p in jdecs.items()}))


def _engine(weights, decoders=True, **kw):
    _, (cfg, base, decs) = weights
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", PAGE)
    return LocalDisaggEngine(cfg, base, decs if decoders else None,
                             device="cpu", **kw)


def _start_decode(eng, tokens=None, max_tokens=6):
    """Admit one request and step until it reaches the decode plane."""
    h = eng.generate("m0", tokens or list(range(1, 12)),
                     SamplingParams(max_tokens=max_tokens))
    for _ in range(32):
        eng.scheduler.step()
        if eng.scheduler.active:
            return h
    raise AssertionError("request never reached decode")


PROMPTS = [[int(t) for t in np.random.default_rng(3).integers(4, 60, size=n)]
           for n in (9, 21, 9, 5)]
CHUNKED = dict(chunked=True, chunk_size=PAGE, token_budget=32)


@pytest.mark.parametrize("mode", ["chunked", "eager"])
def test_sanitize_run_is_token_identical_to_reference(weights, mode):
    """sanitize=True gives the tokens of sanitize=False and of the
    reference's engine on the same weights, and checks every step."""
    (jcfg, jbase, jdecs), _ = weights
    kw = CHUNKED if mode == "chunked" else {}
    jeng = JaxEngine(jcfg, jbase, num_pages=64, page_size=PAGE, **kw)
    for m, p in jdecs.items():
        jeng.models.register(m, p)
    hs = [jeng.generate(f"m{i % 2}", p, JaxSamplingParams(max_tokens=5))
          for i, p in enumerate(PROMPTS)]
    jeng.scheduler.run()
    ref = [[int(t) for t in h.result()] for h in hs]

    def run(sanitize):
        eng = _engine(weights, sanitize=sanitize, **kw)
        hs = [eng.generate(f"m{i % 2}", p, SamplingParams(max_tokens=5))
              for i, p in enumerate(PROMPTS)]
        eng.scheduler.run()
        return [h.result().tolist() for h in hs], eng

    plain, _ = run(False)
    got, eng = run(True)
    assert got == plain == ref
    assert eng.sanitizer is not None
    assert eng.sanitizer.checks == eng.scheduler.stats.steps > 0


def test_sanitize_requires_paged_plane(weights):
    with pytest.raises(ValueError, match="paged"):
        _engine(weights, paged=False, sanitize=True)


# ======================================================================
# seeded corruptions -> precise diagnostics
# ======================================================================

def test_refcount_corruption_trips(weights):
    eng = _engine(weights, chunked=True, sanitize=True)
    _start_decode(eng)
    bid = eng.scheduler.active[0].shared_blocks[0]
    eng.block_pool._refcount[bid] += 1           # phantom reference
    with pytest.raises(SanitizerError,
                       match=f"refcount mismatch on page {bid}"):
        eng.scheduler.step()


def test_leaked_reference_trips(weights):
    eng = _engine(weights, chunked=True, sanitize=True)
    _start_decode(eng)
    leaked = eng.block_pool.alloc(1)[0]          # held by NO engine structure
    with pytest.raises(SanitizerError,
                       match=f"page {leaked} is ACTIVE .* NO engine "
                             f"structure"):
        eng.scheduler.step()


def test_sentinel_in_live_table_trips(weights):
    eng = _engine(weights, chunked=True, sanitize=True)
    _start_decode(eng)
    eng.scheduler.active[0].block_table[0] = BlockPool.SENTINEL
    with pytest.raises(SanitizerError, match="sentinel page 0 appears in "
                                             "the live block table"):
        eng.scheduler.step()


def test_stale_index_entry_trips(weights):
    eng = _engine(weights, chunked=True, sanitize=True)
    _start_decode(eng)
    idx = eng.prefix_index
    free_bid = eng.block_pool._free[-1]
    node = Node(key=(99,) * PAGE, block_id=free_bid, parent=idx.root)
    idx.root.children[node.key] = node
    idx._by_block[free_bid] = node               # index points at a FREE page
    with pytest.raises(SanitizerError,
                       match=f"block {free_bid} but the pool has it FREE"):
        eng.scheduler.step()


def _relay_engine(weights):
    _, (_, base, _) = weights
    eng = _engine(weights, decoders=False, chunked=True, sanitize=True)
    eng.models.register("m_base", base)       # KV path == base: may publish
    prompt = list(range(1, 1 + 2 * PAGE))
    out = eng.generate("m_base", prompt,
                       SamplingParams(max_tokens=PAGE + 2)).result()
    assert eng.stats()["relay_pages_published"] > 0
    relay_bid = next(bid for bid, nd in eng.prefix_index._by_block.items()
                     if nd.provenance == "relay")
    return eng, prompt, out, relay_bid


def test_leaked_relay_page_trips_with_relay_naming(weights):
    """A relay-published page seeded ACTIVE with NO engine holder trips
    with a diagnostic naming relay publication as the holder class."""
    eng, _, _, bid = _relay_engine(weights)
    eng.scheduler.step()                      # clean census first
    eng.block_pool.ref([bid])                 # seeded leak: ACTIVE, no holder
    with pytest.raises(SanitizerError, match=f"page {bid} is ACTIVE .* "
                                             f"holder: relay publication"):
        eng.scheduler.step()


def test_relay_refcount_mismatch_tags_relay_page(weights):
    """A refcount corruption on a relay-published page is tagged as such."""
    eng, prompt, out, relay_bid = _relay_engine(weights)
    # a follower whose prompt EXTENDS the published stream holds the relay
    # page as cached prefix while decoding; corrupt its refcount mid-flight
    eng.generate("m_base", prompt + [2] + [int(t) for t in out],
                 SamplingParams(max_tokens=4))
    for _ in range(32):
        eng.scheduler.step()
        if eng.scheduler.active:
            break
    assert any(relay_bid in s.shared_blocks for s in eng.scheduler.active)
    eng.block_pool._refcount[relay_bid] += 1
    with pytest.raises(SanitizerError, match="relay-published page"):
        eng.scheduler.step()


# ======================================================================
# standalone checkers (no engine), against the reference's on the same
# corruption
# ======================================================================

@pytest.mark.parametrize("impl", ["port", "reference"])
def test_check_pool_diagnoses_direct_corruption(impl):
    pool_cls, check, err = ((BlockPool, check_pool, SanitizerError)
                            if impl == "port" else
                            (JaxBlockPool, jax_check_pool, JaxSanitizerError))
    p = pool_cls(8, 4)
    check(p)                                     # fresh pool is clean
    blocks = p.alloc(2)
    check(p)
    p._refcount[blocks[0]] = -1
    with pytest.raises(err, match="negative"):
        check(p)
    p._refcount[blocks[0]] = 1
    p._free.append(blocks[1])                    # active AND free
    with pytest.raises(err, match="also in the free"):
        check(p)
    p._free.pop()
    p.swap_out([blocks[1]])                      # SWAPPED is a state too
    check(p)
    p._free.append(blocks[1])                    # swapped AND free
    with pytest.raises(err, match="SWAPPED but also"):
        check(p)
    p._free.pop()
    p._refcount[pool_cls.SENTINEL] = 1
    with pytest.raises(err, match="sentinel page 0"):
        check(p)


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_check_index_structural_and_residency(impl):
    pool_cls, index_cls, check, err = (
        (BlockPool, PrefixIndex, check_index, SanitizerError)
        if impl == "port" else
        (JaxBlockPool, JaxPrefixIndex, jax_check_index, JaxSanitizerError))
    pool = pool_cls(8, 2)
    idx = index_cls(2)
    pool.add_evict_callback(idx.remove_block)
    blocks = pool.alloc(2)
    idx.insert([1, 2, 3, 4], blocks)
    check(idx, pool)
    pool.unref(blocks)                           # CACHED: still resident
    check(idx, pool)
    pool.drop(list(blocks))                      # FREE without eviction cb
    with pytest.raises(err, match="FREE"):
        check(idx, pool)


def test_check_index_flags_an_orphan_chain():
    """A node whose ancestor was unregistered (an orphan chain) trips; so
    does a node its parent no longer links (both indexes agree)."""
    for index_cls, node_cls, check, err in (
            (PrefixIndex, Node, check_index, SanitizerError),
            (JaxPrefixIndex, JaxNode, jax_check_index, JaxSanitizerError)):
        idx = index_cls(2)
        idx.insert([1, 2, 3, 4], [5, 6])
        check(idx)
        del idx._by_block[5]                     # ancestor unregistered
        with pytest.raises(err, match="orphan chain"):
            check(idx)
        idx = index_cls(2)
        idx.insert([1, 2], [5])
        stray = node_cls(key=(7, 7), block_id=9, parent=idx.root)
        idx._by_block[9] = stray                 # parent never links it
        with pytest.raises(err, match="not linked from its parent"):
            check(idx)
