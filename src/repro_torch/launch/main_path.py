"""The full-width engines of the smoke run, built in one place.

``chip_smoke.py`` (phases 4 and 5) and ``python -m
repro_torch.launch.profile`` serve from ``build_engine``: Llama-3.1-8B
(``configs/llama31_8b.py``, bf16) with seeded random weights, a frozen base
model and two full-weight decode models built stacked (so the fused plane
stacks them without a copy, ``core/lora.py``), over a pool of 2048 pages of
16 tokens. ``rebuild_engine`` serves the same weight tensors from a new
engine (for instance with ``**CHUNKED``), so the two paths never hold two
copies of the weights.

``build_engine(model=...)`` builds any other config the same way:
``MOE_MODEL`` (granite-moe-3b-a800m) serves on the paged plane (chip_smoke
phase 12), the ``DENSE_ARCHS`` on the dense fallback (phase 13). Those
configs tie their embeddings, and with seeded random weights a tied model
answers with its last input token at every step; ``OUT_SCALE`` scales
their output projections so that the layers, not the embedding, pick the
tokens.
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

#: the MoE config served on the paged plane (40 experts top-8, a query
#: group of 3 at head_dim 64)
MOE_MODEL = "granite-moe-3b-a800m"
#: the dense-fallback archs at full width: name -> depth (None: the
#: config's); gemma2-27b is cut to 4 layers (base + 2 decoders at 46
#: layers are ~163 GB)
DENSE_ARCHS = {"mamba2-780m": None, "recurrentgemma-2b": None,
               "seamless-m4t-medium": None, "gemma2-27b": 4}
#: the dense fallback's session cache rows: past the shared context, both
#: turns' tails and answers (the reference's cache is max(capacity, n) rows
#: long, and a write past its end lands on its last row)
DENSE_CAPACITY = 2048
#: output-projection scale of the random weights of tied-embedding configs
OUT_SCALE = 16.0
_OUT_KEYS = ("wo", "out_proj", "out")


def scale_outputs(tree, factor: float) -> None:
    """Multiply every output projection (attention, MLP and expert
    ``wo``, SSD ``out_proj``, RG-LRU ``out``) by ``factor``, in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in _OUT_KEYS and not isinstance(v, (dict, list)):
                v.mul_(factor)
            else:
                scale_outputs(v, factor)
    elif isinstance(tree, list):
        for v in tree:
            scale_outputs(v, factor)


def build_weights(model: str = MODEL, n_layers: int | None = None,
                  device=None, dtype: str | None = None):
    """``(cfg, base, stacked)``: config ``model`` (``n_layers`` cuts depth
    only, never width; ``dtype``, e.g. ``"float32"``, replaces the config's
    bf16), the base model's seeded random weights (seed 0) and the two
    decoders' built stacked (seeds 1, 2; ``core.lora.unstack_params`` gives
    their views). A tied-embedding config gets ``OUT_SCALE``."""
    cfg = get_config(model)
    if n_layers is not None and n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    base = init_params(cfg, 0, device)
    stacked = init_stacked_params(cfg, [1, 2], device)
    if cfg.tie_embeddings:
        scale_outputs(base, OUT_SCALE)
        scale_outputs(stacked, OUT_SCALE)
    return cfg, base, stacked


def build_engine(n_layers: int | None = None, device=None,
                 dtype: str | None = None, model: str = MODEL, **engine_kw):
    """``(cfg, engine)`` over ``build_weights``' base and two decoders
    (``DECODERS``) and a pool of ``NUM_PAGES`` pages of ``PAGE_SIZE``;
    ``engine_kw`` go to ``LocalDisaggEngine`` (e.g. ``**CHUNKED``)."""
    cfg, base, stacked = build_weights(model, n_layers, device, dtype)
    decs = unstack_params(stacked, len(DECODERS))
    del stacked
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
    """Bytes the engine must hold: the base weights, the decoder weights
    (the fused plane's stacked trees) and the KV pool (none on the dense
    fallback), each storage counted once."""
    tensors = tree_leaves(eng.base_params) + [
        x for dw in eng.decoders.values()
        for x in tree_leaves(dw.spec.full)]
    if eng.decode_plane is not None:
        tensors += [x for g in eng.decode_plane.groups
                    for x in tree_leaves(g.stacked)]
    if eng.kvpool is not None:
        k_layers, v_layers = eng.kvpool.layers()
        tensors += list(k_layers) + list(v_layers)
    storages = {}
    for t in tensors:
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())
