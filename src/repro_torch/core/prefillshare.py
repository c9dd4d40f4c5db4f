"""PrefillShare core (paper §3): the frozen base prefill module and the
cache-compatibility schema.

Port of the serving half of ``repro.core.prefillshare``: one frozen base
model prefills the shared prompt into the paged pool; task-specific decode
models read that KV with zero copy. The schema names which base produced a
cache, so a decoder trained against another base is refused at handoff.
Cache-conditioned fine-tuning arrives with the training slice.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_cache
from repro_torch.params import tree_leaves


@torch.no_grad()
def base_prefill(cfg: ModelConfig, base_params, tokens, *, cache_len: int,
                 pos=None, cache=None):
    """Run the frozen base prefill module; returns (last_logits, C_base).

    Supports PARTIAL prefill: pass an existing ``cache`` + ``pos`` to extend
    it with newly appended tokens only (paper §3.3 step 1). The cache is
    updated in place."""
    B = tokens.shape[0]
    device = tokens.device
    if cache is None:
        cache = init_cache(cfg, B, cache_len, device=device)
    if pos is None:
        pos = torch.zeros((B,), dtype=torch.int32, device=device)
    return forward(cfg, base_params, tokens, cache=cache, pos=pos)


@torch.no_grad()
def base_prefill_paged(cfg: ModelConfig, base_params, new_tokens, *,
                       pool, block_table, n_cached: int):
    """Partial prefill against the paged data plane (§3.3 step 1).

    The cached prefix (``n_cached`` tokens, page-aligned by construction)
    is gathered out of ``pool`` via ``block_table`` into a dense working
    cache; the frozen base model runs over ``new_tokens`` (1, S) only; the
    fresh KV rows are scattered back into the pool's pages with the
    ``paged_write`` kernel. Returns the last-token logits. B=1.

    The cached pages may be prefill-published or relay-published
    (decode-written by a finished sequence of a relay-compatible decoder);
    the gather treats both alike."""
    if n_cached % pool.page_size:
        raise ValueError("prefix reuse is page-granular")
    cache = pool.gather_prefill_cache(block_table, n_cached)
    out, cache = base_prefill(
        cfg, base_params, new_tokens,
        cache_len=len(block_table) * pool.page_size, cache=cache,
        pos=torch.tensor([n_cached], dtype=torch.int32,
                         device=new_tokens.device))
    start = n_cached // pool.page_size
    pool.scatter_from_dense(cache, block_table, start,
                            len(block_table) - start)
    return out


# ======================================================================
# Cache compatibility schema (handoff contract)


@dataclass(frozen=True)
class CacheSchema:
    """Identity of a shared cache: which frozen base produced it, over what."""
    base_model_id: str       # id of θ_base (hash of config + param fingerprint)
    arch: str
    n_layers: int
    cache_len: int
    dtype: str

    def compatible_with(self, other: "CacheSchema") -> bool:
        return (self.base_model_id == other.base_model_id
                and self.arch == other.arch
                and self.n_layers == other.n_layers
                and self.dtype == other.dtype)


def model_fingerprint(cfg: ModelConfig, params) -> str:
    """Cheap, deterministic parameter fingerprint (sums of a few leaves).
    Stable within the port; not equal to the reference's."""
    leaves = tree_leaves(params)
    probe = [float(leaf.float().sum()) for leaf in leaves[:4]]
    blob = json.dumps({"cfg": cfg.name, "n": len(leaves), "probe": probe})
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def cache_schema(cfg: ModelConfig, base_params, cache_len: int) -> CacheSchema:
    return CacheSchema(
        base_model_id=model_fingerprint(cfg, base_params),
        arch=cfg.name, n_layers=cfg.n_layers, cache_len=cache_len,
        dtype=cfg.dtype)
