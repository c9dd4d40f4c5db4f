"""The fused decode step's shape buckets and its CUDA-graph key cache
(``serving/decode.py``), on the CPU:

- the bucketed, fixed-length step (an (M, next_pow2) grid whose pad
  positions of ``rows`` repeat the first real row) gives the same tokens
  and the same pool bytes as the unbucketed step it replaced, over mixed
  models with pad rows, an all-real grid, steps that cross an ``npages``
  bucket, a seeded sampled batch and an MoE group; sentinel page 0 stays
  bitwise zero and ``grid_rows`` is M * next_pow2(max(counts));
- the key cache captures once per (bucket, npages) key and replays after,
  through a stand-in for the capture (the CPU has no CUDA graphs), and a
  replay adds the launches its capture counted;
- a LoRA group and a CPU pool never capture, and a plane rebuilt by churn
  starts with no graphs;
- ``decode_graph_replays``/``decode_graph_captures`` and the
  ``engine.step`` span's ``decode_forwards``/``decode_graphed`` count the
  forwards and the replays.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.lora import lora_init
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import decode_stacked, init_params
from repro_torch.serving import LocalDisaggEngine, SamplingParams
from repro_torch.serving import metrics as M
from repro_torch.serving.decode import (StackedDecoders, next_pow2,
                                        next_tokens)
from repro_torch.serving.engine import DecodeSeq
from repro_torch.serving.registry import DecodeModelSpec, LoRAAdapter

CFG = ModelConfig(name="graph-dec", arch_type="dense", n_layers=2,
                  d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                  vocab_size=64, dtype="float32")
MOE = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(
    vocab=64), dtype="float32")
PAGE = 2
PAGES = 96


def _group(cfg, n_models, seed=0, pool=None):
    members = {f"m{m}": DecodeModelSpec(full=init_params(cfg, seed + m,
                                                         device="cpu"))
               for m in range(n_models)}
    if pool is None:
        pool = PagedKVPool(cfg, PAGES, PAGE, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for k, v in zip(*pool.layers()):
            k[1:].normal_(generator=gen)
            v[1:].normal_(generator=gen)
    return StackedDecoders(cfg, members, pool)


def _twin(group):
    """A group over a copy of ``group``'s pool with the same weights."""
    pool = PagedKVPool(group.cfg, PAGES, PAGE, device="cpu")
    for dst, src in zip(sum(pool.layers(), []), sum(group.kvpool.layers(),
                                                    [])):
        dst.copy_(src)
    twin = StackedDecoders.__new__(StackedDecoders)
    twin.__dict__.update(group.__dict__, kvpool=pool, _graphs={})
    return twin


def _seqs(cases, sampled=False):
    """Decode sequences from (model index, context length): each on pages
    of its own (context pages hold the pool's random K/V), covering the
    position it writes next."""
    seqs, page = [], 1
    for i, (m, n) in enumerate(cases):
        bt = list(range(page, page + n // PAGE + 1))
        page += len(bt)
        params = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                 seed=11 + i) if sampled and i % 2
                  else SamplingParams(seed=11 + i))
        seqs.append(DecodeSeq(rid=i, sid=i, model_id=f"m{m}",
                              block_table=bt, shared_blocks=[],
                              private_blocks=[], pos=n,
                              next_token=(7 * i + 3) % 64, remaining=99,
                              params=params))
    return seqs


def _advance(seqs, toks, free):
    """Feed each token back and grow tail pages as the engine does; ``free``
    hands out page ids (the same for twin runs)."""
    for s, t in zip(seqs, toks):
        s.next_token, s.pos = t, s.pos + 1
        if s.pos >= len(s.block_table) * PAGE:
            s.block_table.append(free.pop())


def unbucketed_step(group, seqs):
    """The fused step before shape buckets: an (M, max(counts)) grid, and
    only the real rows' flat indices reach the pool writes."""
    Mn = len(group.model_ids)
    counts, coords = [0] * Mn, []
    for s in seqs:
        m = group.index[s.model_id]
        coords.append((m, counts[m]))
        counts[m] += 1
    bmax = max(counts)
    npages = next_pow2(max(len(s.block_table) for s in seqs))
    toks = np.zeros((Mn, bmax), np.int32)
    pos = np.zeros((Mn, bmax), np.int32)
    bts = np.zeros((Mn * bmax, npages), np.int32)
    for s, (m, b) in zip(seqs, coords):
        toks[m, b], pos[m, b] = s.next_token, s.pos
        bts[m * bmax + b, :len(s.block_table)] = s.block_table
    flat = torch.tensor([m * bmax + b for m, b in coords], dtype=torch.int64)
    rows = flat if len(seqs) < Mn * bmax else None
    logits = decode_stacked(group.cfg, group.stacked, torch.from_numpy(toks),
                            torch.from_numpy(pos), *group.kvpool.layers(),
                            torch.from_numpy(bts), rows=rows,
                            lanes=group._lanes)
    return next_tokens(logits.reshape(Mn * bmax, -1).index_select(0, flat),
                       seqs, "cpu")


def _pools_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(sum(a.layers(), []),
                                                 sum(b.layers(), [])))


def _page0_zero(pool):
    return all(not t[0].any() for t in sum(pool.layers(), []))


def _fake_capture(calls, launches=0):
    """A stand-in for ``StackedDecoders.capture``: runs the forward (as a
    capture records it) and returns a replay that recomputes it from the
    static inputs into the same logits; bumps the Python launch counter by
    ``launches``, as a capture of that many kernel launches would."""
    def capture(forward):
        calls.append(forward)
        paged_decode_attention.launches += launches
        out = forward()
        return (lambda: out.copy_(forward())), out
    return capture


# (config, models, (model, context length) per sequence, steps, sampled)
CASES = {
    "pad_rows": (CFG, 3, [(0, 5), (0, 9), (0, 2), (1, 7), (2, 4), (2, 11)],
                 3, False),
    "all_real": (CFG, 2, [(0, 6), (1, 3), (0, 10), (1, 8)], 3, False),
    # the longest table grows from 2 pages to 3 and 5: npages 2 -> 4 -> 8
    "crosses_npages": (CFG, 2, [(0, 3), (1, 2), (1, 1)], 6, False),
    "sampled": (CFG, 2, [(0, 5), (1, 9), (1, 6), (0, 12), (1, 2)], 3, True),
    "moe": (MOE, 2, [(0, 5), (1, 9), (1, 6)], 3, False),
    # model 0 idle: grid row 0 is padding, over sentinel page 0
    "idle_first_model": (CFG, 3, [(1, 5), (2, 3), (2, 8)], 3, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucketed_step_matches_unbucketed(case):
    cfg, n_models, spec, steps, sampled = CASES[case]
    group = _group(cfg, n_models)
    old = _twin(group)
    seqs, ref = _seqs(spec, sampled), _seqs(spec, sampled)
    free_a, free_b = list(range(60, 96)), list(range(60, 96))
    counts = np.bincount([m for m, _ in spec], minlength=n_models)
    npages_seen = set()
    for _ in range(steps):
        npages_seen.add(next_pow2(max(len(s.block_table) for s in seqs)))
        got = group.step(seqs)
        want = unbucketed_step(old, ref)
        assert got == want
        assert group.grid_rows == n_models * next_pow2(counts.max())
        assert _pools_equal(group.kvpool, old.kvpool)
        assert _page0_zero(group.kvpool)
        _advance(seqs, got, free_a)
        _advance(ref, want, free_b)
    if case == "crosses_npages":
        assert npages_seen == {2, 4, 8}
    if case == "all_real":
        assert group.grid_rows == len(spec)
    else:
        assert group.grid_rows > len(spec)


def test_pad_positions_repeat_the_first_real_row(monkeypatch):
    """The rows the forward writes: the real rows' flat indices in the
    sequences' order, then the first of them in every pad position."""
    group = _group(CFG, 3)
    seqs = _seqs([(2, 5), (0, 3), (2, 7)])
    seen = []

    def spy(*a, rows=None, **kw):
        seen.append(rows.clone())
        return decode_stacked(*a, rows=rows, **kw)
    monkeypatch.setattr("repro_torch.serving.decode.decode_stacked", spy)
    group.step(seqs)
    # bucket 2: model 2's rows are flat 4 and 5, model 0's row flat 0
    assert seen[0].tolist() == [4, 0, 5, 4, 4, 4]
    assert group.grid_rows == 6


def test_key_cache_captures_once_per_key_and_replays():
    group = _group(CFG, 2)
    eager = _twin(group)
    calls = []
    group.graphed, group.capture = True, _fake_capture(calls)
    seqs, ref = (_seqs(CASES["crosses_npages"][2]) for _ in range(2))
    free_a, free_b = list(range(60, 96)), list(range(60, 96))
    keys = []
    for _ in range(6):
        keys.append((2, next_pow2(max(len(s.block_table) for s in seqs))))
        got, want = group.step(seqs), eager.step(ref)
        assert got == want
        assert _pools_equal(group.kvpool, eager.kvpool)
        _advance(seqs, got, free_a)
        _advance(ref, want, free_b)
    assert keys == [(2, 2), (2, 4), (2, 4), (2, 4), (2, 4), (2, 8)]
    assert sorted(group._graphs) == [(2, 2), (2, 4), (2, 8)]
    assert len(calls) == group.graph_captures == 3
    assert group.graph_replays == 3 and group.dispatches == 6
    assert eager.graph_captures == eager.graph_replays == 0


def test_replay_adds_the_launches_its_capture_counted(monkeypatch):
    monkeypatch.setattr(paged_decode_attention, "launches", 0)
    group = _group(CFG, 2)
    group.graphed, group.capture = True, _fake_capture([], launches=5)
    seqs = _seqs([(0, 4), (1, 4)])        # npages 4 over the four steps
    free = list(range(60, 96))
    _advance(seqs, group.step(seqs), free)
    assert paged_decode_attention.launches == 0    # a capture runs nothing
    for i in range(3):
        _advance(seqs, group.step(seqs), free)
        assert paged_decode_attention.launches == 5 * (i + 1)
    assert group.graph_replays == 3


def test_lora_group_and_cpu_pool_never_capture():
    base = init_params(CFG, 0, device="cpu")
    card = SimpleNamespace(device=torch.device("cuda"), page_size=PAGE)
    lora = {f"l{i}": DecodeModelSpec(lora=LoRAAdapter(lora_init(
        base, rank=4, generator=torch.Generator().manual_seed(i)),
        alpha=8.0, rank=4)) for i in range(2)}
    full = {"m0": DecodeModelSpec(full=init_params(CFG, 1, device="cpu"))}
    assert not StackedDecoders(CFG, lora, card, base).graphed
    assert StackedDecoders(CFG, full, card).graphed
    assert not _group(CFG, 2).graphed


def _engine(**kw):
    base = init_params(CFG, 0, device="cpu")
    decs = {f"m{i}": init_params(CFG, 1 + i, device="cpu") for i in range(2)}
    return LocalDisaggEngine(CFG, base, decs, device="cpu", num_pages=128,
                             page_size=8, chunked=True, chunk_size=8,
                             token_budget=32, **kw)


def _serve(eng, n=5, gen=6):
    rng = np.random.default_rng(3)
    outs = [eng.generate(f"m{i % 2}", list(rng.integers(4, 60, size=9 + 5 * i)),
                         SamplingParams(max_tokens=gen)) for i in range(n)]
    eng.run()
    assert all(o.finished for o in outs)
    return [o.tokens for o in outs]


def test_cpu_engine_counts_no_graphs():
    eng = _engine()
    _serve(eng)
    assert eng.stats.decode_dispatches > 0
    assert eng.stats.decode_graph_captures == eng.stats.decode_graph_replays \
        == 0
    assert all(not g.graphed and not g._graphs
               for g in eng.decode_plane.groups)


def test_engine_counters_and_step_spans_count_replays():
    plain = _serve(_engine())
    eng = _engine()
    calls = []
    for g in eng.decode_plane.groups:
        g.graphed, g.capture = True, _fake_capture(calls)
    i0 = M.SPANS._next
    assert _serve(eng) == plain
    st = eng.stats
    assert st.decode_graph_captures == len(calls) > 0
    assert st.decode_graph_replays == st.decode_dispatches - len(calls) > 0
    assert eng.metrics()["counters"][
        "engine_decode_graph_replays_total"] == st.decode_graph_replays
    steps = [s for s in M.spans() if s.index >= i0 and s.name == M.SPAN_STEP]
    assert sum(s.attrs["decode_forwards"] for s in steps) \
        == st.decode_dispatches
    assert sum(s.attrs["decode_graphed"] for s in steps) \
        == st.decode_graph_replays
    assert all(s.attrs["decode_graphed"] <= s.attrs["decode_forwards"] <= 1
               for s in steps)


def test_plane_rebuilt_by_churn_starts_with_no_graphs():
    eng = _engine()
    for g in eng.decode_plane.groups:
        g.graphed, g.capture = True, _fake_capture([])
    _serve(eng, n=2, gen=4)
    assert any(g._graphs for g in eng.decode_plane.groups)
    eng.models.register("m2", DecodeModelSpec(full=init_params(CFG, 9,
                                                               device="cpu")))
    eng.step()                              # the step boundary relayouts
    assert eng.stats.plane_rebuilds == 1
    assert all(not g._graphs and g.graph_captures == 0
               for g in eng.decode_plane.groups)
