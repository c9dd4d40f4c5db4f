"""The main path's engine at full width, built in one place.

``chip_smoke.py`` (phases 4 and 5) and ``python -m
repro_torch.launch.profile`` serve from ``build_engine``: Llama-3.1-8B
(``configs/llama31_8b.py``, bf16) with seeded random weights, a frozen base
model and two full-weight decode models built stacked (so the fused plane
stacks them without a copy, ``core/lora.py``), over a pool of 2048 pages of
16 tokens. ``rebuild_engine`` serves the same weight tensors from a new
engine (for instance with ``**CHUNKED``), so the two paths never hold two
copies of the weights.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import get_config
from repro_torch.core.lora import unstack_params
from repro_torch.models import init_params, init_stacked_params
from repro_torch.params import tree_leaves
from repro_torch.serving import LocalDisaggEngine

MODEL = "llama31-8b"
DECODERS = ("m0", "m1")
NUM_PAGES = 2048
PAGE_SIZE = 16
PROMPT_TOKENS = 1000        # the shared context
TAIL_TOKENS = 32            # each request's private tail
#: the chunked main path: 200 is not a multiple of the 16-token page, so
#: the shared context's chunks start mid-page; with a 1000-token context the
#: four 32-token tails (40 uncached tokens each past the 992 cached) batch
#: into one B=4 chunk forward
CHUNKED = {"chunked": True, "chunk_size": 200, "token_budget": 512}


def build_engine(n_layers: int | None = None, device=None,
                 dtype: str | None = None, **engine_kw):
    """``(cfg, engine)``; ``n_layers`` cuts depth only, never width;
    ``dtype`` (e.g. ``"float32"``) replaces the config's bf16;
    ``engine_kw`` go to ``LocalDisaggEngine`` (e.g. ``**CHUNKED``)."""
    cfg = get_config(MODEL)
    if n_layers is not None and n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    base = init_params(cfg, 0, device)
    decs = unstack_params(init_stacked_params(cfg, [1, 2], device),
                          len(DECODERS))
    eng = LocalDisaggEngine(cfg, base, dict(zip(DECODERS, decs)),
                            device=device, num_pages=NUM_PAGES,
                            page_size=PAGE_SIZE, **engine_kw)
    return cfg, eng


def rebuild_engine(eng, **engine_kw):
    """A new engine over ``eng``'s weight tensors (no copy: the decoders
    are the same rows of one stacked tree) with a fresh pool of the same
    size. Drop ``eng`` to free its pool."""
    decs = {mid: dw.spec.full for mid, dw in eng.decoders.items()}
    return LocalDisaggEngine(eng.cfg, eng.base_params, decs,
                             device=eng.device, num_pages=NUM_PAGES,
                             page_size=PAGE_SIZE, **engine_kw)


def preempt_engine(cfg, decoders: dict, device, num_pages: int,
                   **engine_kw):
    """An engine over the two stacked decoders ``{"m0", "m1"}`` (rows 0
    and 1 of one ``init_stacked_params`` tree) for the preemption fleet:
    row 1 serves as the frozen base AND is registered as model ``"mb"``
    (the base itself: relay-compatible, so a victim of it may be dropped
    and re-prefilled), row 0 as ``"m0"`` (its own weights: swap only). The
    two are consecutive rows of one tree, so the fused plane stacks them as
    a view and nothing is copied (a tree built on its own beside rows of a
    stacked one would need a copy, which ``core/lora.py`` refuses)."""
    base = decoders["m1"]
    return LocalDisaggEngine(cfg, base, {"m0": decoders["m0"], "mb": base},
                             device=device, num_pages=num_pages,
                             page_size=PAGE_SIZE, **engine_kw)


def tokens(cfg, rng, n: int) -> list:
    """``n`` random token ids (ids below 4 are left to special tokens)."""
    return [int(t) for t in rng.integers(4, cfg.vocab_size, n)]


def resident_bytes(eng) -> int:
    """Bytes the engine must hold: the base weights, the fused plane's
    stacked decoder weights and the KV pool, each storage counted once."""
    tensors = tree_leaves(eng.base_params) + [
        x for g in eng.decode_plane.groups for x in tree_leaves(g.stacked)]
    k_layers, v_layers = eng.kvpool.layers()
    storages = {}
    for t in tensors + list(k_layers) + list(v_layers):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())
