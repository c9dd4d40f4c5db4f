"""PrefillShare core (paper §3): the frozen base prefill module,
cache-conditioned fine-tuning (Eq. 7) and the cache-compatibility schema.

Port of ``repro.core.prefillshare``. One frozen base model prefills the
shared prompt into the paged pool (whole, or in chunks that attend
straight from the pages); task-specific decode models read that KV with
zero copy. Archs whose sequence state is not paged KV (SSD and RG-LRU
states, window caches, enc-dec cross caches) prefill into a dense cache
instead (``base_prefill``), which the decode model receives as a copy. The
schema names which base produced a cache, so a decoder trained against
another base is refused at handoff.

Cache-conditioned fine-tuning (Eq. 7):
    L(θ_dec) = −Σ_t log P(y_t | y_<t, stop_grad(C_base); θ_dec)
teacher forcing over the target, the prompt's cache produced by the frozen
base. Every decode module is trained against the same frozen prefill, so
their caches are mutually compatible and one prefill serves them all.
``share_ratio`` (the paper's Fig. 2 knob) is the fraction of layers whose
prompt cache comes from the base; the rest come from the decode model's own
prefill, which then stays in the autograd graph.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encode, forward, init_cache
from repro_torch.models.layers import unembed
from repro_torch.models.model import train_loss
from repro_torch.params import tree_leaves, tree_map


def base_prefill(cfg: ModelConfig, base_params, tokens, *, cache_len: int,
                 pos=None, cache=None, prefix_embeds=None, enc_embeds=None,
                 stop_grad: bool = True):
    """Run the (frozen) base prefill module; returns (last_logits, C_base).

    Supports PARTIAL prefill: pass an existing ``cache`` + ``pos`` to extend
    it with newly appended tokens only (paper §3.3 step 1). Serving (no
    autograd recording) updates the cache in place; while autograd records
    the forward returns a new cache (``models.forward``). ``stop_grad``
    detaches the returned cache from the graph (Eq. 7's
    ``stop_grad(C_base)``); False keeps it (a decode model's own prompt
    cache under ``share_ratio < 1``). ``prefix_embeds`` feed a mixed- or
    embeds-input model; ``enc_embeds`` an enc-dec model's encoder, whose
    output fills the cross cache (``enc_len`` rows)."""
    B = tokens.shape[0]
    device = tokens.device
    enc_out = None
    if cfg.is_encdec and enc_embeds is not None:
        enc_out = encode(cfg, base_params, enc_embeds)
    if cache is None:
        enc_len = enc_embeds.shape[1] if enc_embeds is not None else 0
        cache = init_cache(cfg, B, cache_len, device=device, enc_len=enc_len)
    if pos is None:
        pos = torch.zeros((B,), dtype=torch.int32, device=device)
    out, cache, _ = forward(cfg, base_params, tokens, cache=cache, pos=pos,
                            prefix_embeds=prefix_embeds, enc_out=enc_out)
    if stop_grad:
        cache = tree_map(torch.Tensor.detach, cache)
    return out, cache


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


@torch.no_grad()
def base_prefill_chunk(cfg: ModelConfig, base_params, tokens, *, pool,
                       block_tables, pos):
    """One chunked-prefill step against the paged plane (the scheduler's
    prefill primitive).

    Unlike ``base_prefill_paged`` there is NO dense gather of the prefix:
    in one forward, each layer scatters the chunk's fresh K/V rows into
    their pool pages in place and the chunk queries attend to prefix plus
    chunk straight from the pages (``flash_prefill_paged`` on the card, its
    plain version on the CPU). Prefix pages may be prefill- or
    relay-published, as for ``base_prefill_paged``. Batches chunks from
    several requests: ``tokens`` (B, S) int32, ``pos`` (B,) absolute start
    positions, ``block_tables`` (B, npages) zero-padded to a common width
    (the scheduler buckets it to a power of two, the shape key a captured
    CUDA graph will need). Chunk starts and the cached-prefix boundary may
    land mid-page. Returns the pool cache it wrote. The reference also
    counts jit retraces here (``CHUNK_TRACES``); eager PyTorch does not
    trace, so the port has no counterpart."""
    dev = pool.device
    cache = pool.make_decode_cache(
        torch.as_tensor(block_tables, dtype=torch.int32).to(dev))
    forward(cfg, base_params,
            torch.as_tensor(tokens, dtype=torch.int32).to(dev),
            cache=cache, pos=torch.as_tensor(pos, dtype=torch.int32).to(dev),
            logits="hidden")
    return cache


# ======================================================================
# Share-ratio mixing (Fig. 2 mechanism)


def _layer_share_mask(cfg: ModelConfig, ratio: float):
    """Boolean per layer: True = use the base model's cache for this layer.
    The first ``round(ratio * n_layers)`` layers share (bottom-up, the
    paper's progressive-sharing sweep)."""
    n = cfg.n_layers
    k = int(round(ratio * n))
    return [i < k for i in range(n)]


def mix_caches(cfg: ModelConfig, cache_base, cache_self, ratio: float):
    """Per-layer blend: layers under the share mask take the base cache.
    A stacked group picks per layer along its ``n_full`` axis
    (``torch.where``); a tail layer is taken whole from one side."""
    if ratio >= 1.0:
        return cache_base
    if ratio <= 0.0:
        return cache_self
    mask = _layer_share_mask(cfg, ratio)
    pat = cfg.layer_pattern
    n_full = cfg.n_layers // len(pat)

    def pick(m, b, s):
        sel = torch.tensor(m, device=b.device).reshape(
            (n_full,) + (1,) * (b.dim() - 1))
        return torch.where(sel, b, s)

    groups = {}
    for i in range(len(pat)):
        m = [mask[g * len(pat) + i] for g in range(n_full)]
        groups[f"pos{i}"] = tree_map(lambda b, s, m=m: pick(m, b, s),
                                     cache_base["groups"][f"pos{i}"],
                                     cache_self["groups"][f"pos{i}"])
    tail = [bt if mask[n_full * len(pat) + t] else st
            for t, (bt, st) in enumerate(zip(cache_base["tail"],
                                             cache_self["tail"]))]
    return {"groups": groups, "tail": tail}


# ======================================================================
# Cache-conditioned fine-tuning loss (Eq. 7)


def cache_conditioned_loss(cfg: ModelConfig, dec_params, base_params, prompt,
                           target_in, target_out, target_mask, *,
                           share_ratio: float = 1.0, prefix_embeds=None,
                           enc_embeds=None, remat: bool = False,
                           ce_chunk: int = 512):
    """−Σ log P(y_t | y_<t, C_base; θ_dec) / Σ mask, gradients only through
    θ_dec (the base's cache is detached). prompt: (B, Sp) shared-context
    tokens; target_in/out: (B, St) teacher-forced decoder input and
    next-token labels; target_mask: (B, St). ``share_ratio < 1`` mixes in
    the decode model's own prompt cache, kept in the graph. An MoE model
    adds 0.01 times the decode forward's load-balancing loss. Returns
    (loss, aux); the target's logits are taken whole, as in the
    reference, which accepts ``ce_chunk`` and ignores it."""
    B, Sp = prompt.shape
    St = target_in.shape[1]
    npfx = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    cache_len = Sp + npfx + St
    kw = dict(cache_len=cache_len, prefix_embeds=prefix_embeds,
              enc_embeds=enc_embeds)
    _, c_base = base_prefill(cfg, base_params, prompt, stop_grad=True, **kw)
    if share_ratio < 1.0:
        _, c_self = base_prefill(cfg, dec_params, prompt, stop_grad=False,
                                 **kw)
        cache = mix_caches(cfg, c_base, c_self, share_ratio)
    else:
        cache = c_base
    pos = torch.full((B,), Sp + npfx, dtype=torch.int32, device=prompt.device)
    hidden, _, aux = forward(cfg, dec_params, target_in, cache=cache, pos=pos,
                             logits="hidden", remat=remat)
    table = dec_params.get("unembed", dec_params["embed"])
    logits = unembed(hidden, table, cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, target_out.long()[..., None])[..., 0]
    nll = (lse - picked) * target_mask
    loss = nll.sum() / torch.clamp(target_mask.sum(), min=1.0)
    if cfg.is_moe:
        loss = loss + 0.01 * aux["lb_loss"]
    return loss, aux


def full_ft_loss(cfg: ModelConfig, params, prompt, target_in, target_out,
                 target_mask, **kw):
    """Baseline: standard full fine-tuning (the model's own cache). A plain
    next-token loss over [prompt; target] masked to the target segment; the
    prompt's last token predicts ``target_in[:, 0]``."""
    tokens = torch.cat([prompt, target_in], dim=1)
    pmask = torch.zeros(prompt.shape, dtype=torch.float32,
                        device=prompt.device)
    tgt = torch.cat([prompt[:, 1:], target_in[:, :1], target_out], dim=1)
    mask = torch.cat([pmask, target_mask], dim=1)
    return train_loss(cfg, params, tokens, tgt, mask, remat=False,
                      prefix_embeds=kw.get("prefix_embeds"),
                      enc_embeds=kw.get("enc_embeds"))


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
