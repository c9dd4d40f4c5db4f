"""Attention: GQA with RoPE variants, softcaps, dense and paged caches.

Port of ``repro.models.attention``. Two dense execution paths share one mask
semantics (positions are explicit: ``q_pos`` (B, Sq), ``k_pos`` (B, Tk),
``k_pos = -1`` marks an unwritten cache slot):
  - ``_direct``: materialized scores (the default below the flash switch);
  - ``_flash``: chunked online softmax, forward only in this slice.
Both keep the reference's op order, so the paged plane (``_paged_apply``)
and the dense path give identical greedy tokens.

The paged plane writes each step's K/V rows straight into the shared pool
with an in-place ``index_put_`` (the reference's ``kp.at[pg, slot].set``)
and attends with the ``paged_decode`` kernel (its plain version on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.models.layers import rmsnorm
from repro_torch.models.rope import apply_rope

_NEG = -1e30


def _pick_chunk(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def _block_mask(qp, kp, window):
    """qp: (B, Cq), kp: (B, Ck) -> bool (B, 1, 1, Cq, Ck)."""
    m = (kp[:, None, :] <= qp[:, :, None]) & (kp[:, None, :] >= 0)
    if window:
        m &= kp[:, None, :] > (qp[:, :, None] - window)
    return m[:, None, None, :, :]


def _softcap(s, cap):
    return torch.tanh(s / cap) * cap if cap else s


def _direct(qg, k, v, q_pos, k_pos, window, softcap):
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = _softcap(s, softcap)
    s = torch.where(_block_mask(q_pos, k_pos, window), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.to(v.dtype)


def _flash(qg, k, v, q_pos, k_pos, window, softcap, q_chunk, kv_chunk):
    """Forward of the reference's ``_flash_fwd_impl``: online softmax over
    kv chunks, one q chunk at a time. Returns (B, Sq, Hkv, G, D)."""
    B, Sq, Hkv, G, D = qg.shape
    Tk = k.shape[1]
    Cq = _pick_chunk(Sq, q_chunk)
    Ck = _pick_chunk(Tk, kv_chunk)
    outs = []
    for q0 in range(0, Sq, Cq):
        qb = qg[:, q0:q0 + Cq].float()
        qp = q_pos[:, q0:q0 + Cq]
        m = torch.full((B, Hkv, G, Cq), _NEG, dtype=torch.float32,
                       device=qg.device)
        lden = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, Cq, D), dtype=torch.float32,
                          device=qg.device)
        for k0 in range(0, Tk, Ck):
            kb, vb = k[:, k0:k0 + Ck].float(), v[:, k0:k0 + Ck].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            s = _softcap(s, softcap)
            mask = _block_mask(qp, k_pos[:, k0:k0 + Ck], window)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            lden = lden * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vb)
            m = m_new
        o = acc / torch.clamp(lden, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(v.dtype))   # (B,Cq,Hkv,G,D)
    return torch.cat(outs, dim=1)


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, softcap=None,
              scale=None, q_chunk: int = 1024, kv_chunk: int = 2048,
              force_flash: bool | None = None):
    """q: (B,Sq,Hq,D); k/v: (B,Tk,Hkv,D); returns (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = (q * (scale if scale is not None else D ** -0.5)).reshape(
        B, Sq, Hkv, G, D)
    use_flash = force_flash if force_flash is not None else (
        Sq * Tk > 4096 * 2048)
    if use_flash:
        o = _flash(qg, k, v, q_pos, k_pos, window, softcap, q_chunk, kv_chunk)
    else:
        o = _direct(qg, k, v, q_pos, k_pos, window, softcap)
    return o.reshape(B, Sq, Hq, D)


# ======================================================================
# Paged decode attention (shared-pool data plane)

PAGED_CACHE_KEYS = ("k_pages", "v_pages", "block_tables")


def paged_decode_rows(q, k, v, k_pages, v_pages, block_tables, pos, *,
                      softcap=None):
    """One decode token per row: write each row's K/V into its page slot of
    the shared pool IN PLACE, then attend over the row's block table.

    q: (N, Hq, D); k/v: (N, Hkv, D) post-rope; k/v_pages: (P, page, Hkv, D);
    block_tables: (N, npages) int32; pos: (N,) int32 position of the token.
    Written pages are private per sequence (fresh decode pages, or the
    handoff's copy-on-write clone); rows padded into a batch point at
    sentinel page 0, which is never read as live KV, so the scatter is
    exact whatever order duplicate sentinel writes land in."""
    page = k_pages.shape[1]
    pos_l = pos.long()
    pg = block_tables.gather(1, (pos_l // page)[:, None])[:, 0].long()
    slot = pos_l % page
    k_pages.index_put_((pg, slot), k)
    v_pages.index_put_((pg, slot), v)
    return paged_decode_attention(q, k_pages, v_pages, block_tables, pos + 1,
                                  softcap=softcap or 0.0)


def _paged_apply(p, q, k, v, cache, pos, cfg):
    """S == 1: the decode step over the paged pool. q/k/v: post-rope
    (B, 1, H, D). The pool pages in ``cache`` are updated in place."""
    B, S = q.shape[0], q.shape[1]
    if S != 1:
        raise NotImplementedError("chunked prefill: port slice 2")
    kp, vp, bt = (cache[key] for key in PAGED_CACHE_KEYS)
    o = paged_decode_rows(q[:, 0], k[:, 0], v[:, 0], kp, vp, bt, pos,
                          softcap=cfg.attn_softcap)
    return o.reshape(B, S, -1) @ p["wo"], cache


# ======================================================================
# Attention block: projections + rope + cache plumbing


def _update_global(cache, k, v, q_pos):
    """Write (B, S, f) rows at positions ``q_pos = pos + arange(S)`` into the
    dense cache, in place (the reference's functional
    dynamic_update_slice; the rows must fit the cache)."""
    B, S = q_pos.shape
    rows = q_pos.long()
    bidx = torch.arange(B, device=rows.device)[:, None].expand(B, S)
    cache["k"].index_put_((bidx, rows), k)
    cache["v"].index_put_((bidx, rows), v)
    cache["kpos"].index_put_((bidx, rows), q_pos)
    return cache


def project_qkv(p, x, cfg, q_pos):
    """q/k/v projections, optional qk-norm and rope. x: (B, S, d);
    q_pos: (B, S). Returns q (B,S,Hq,D), k and v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, hq, hd)
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_pos, style=cfg.rope_style, theta=cfg.rope_theta)
    k = apply_rope(k, q_pos, style=cfg.rope_style, theta=cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg, *, cache=None, pos=None):
    """One causal global-attention layer. x: (B, S, D); pos: (B,) starting
    absolute position of x's first token; cache: dense or paged cache dict,
    or None. Returns (out, cache); caches are updated in place."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if pos is None:
        pos = torch.zeros((B,), dtype=torch.int32, device=x.device)
    q_pos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                        device=x.device)[None, :]
    q, k, v = project_qkv(p, x, cfg, q_pos)

    if cache is not None and "k_pages" in cache:
        return _paged_apply(p, q, k, v, cache, pos, cfg)

    if cache is None:
        o = attention(q, k, v, q_pos, q_pos, softcap=cfg.attn_softcap)
    else:
        cache = _update_global(cache, k.reshape(B, S, hkv * hd),
                               v.reshape(B, S, hkv * hd), q_pos)
        t = cache["k"].shape[1]
        o = attention(q, cache["k"].reshape(B, t, hkv, hd),
                      cache["v"].reshape(B, t, hkv, hd), q_pos, cache["kpos"],
                      softcap=cfg.attn_softcap)
    return o.reshape(B, S, hq * hd) @ p["wo"], cache
