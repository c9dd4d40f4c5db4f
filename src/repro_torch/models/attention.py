"""Attention: GQA with RoPE variants, sliding windows, softcaps, dense and
paged caches, and the enc-dec cross-attention block.

Port of ``repro.models.attention``. Two dense execution paths share one mask
semantics (positions are explicit: ``q_pos`` (B, Sq), ``k_pos`` (B, Tk),
``k_pos = -1`` marks an unwritten cache slot):
  - ``_direct``: materialized scores (the default below the flash switch);
  - ``_flash``: chunked online softmax, differentiable through
    ``_FlashAttention`` (the reference's ``custom_vjp``: only ``o`` and the
    log-sum-exp are saved, each block's scores are recomputed backward).
Both keep the reference's op order, so the paged plane (``_paged_apply``)
and the dense path give identical greedy tokens.

Dense caches are written in place while serving. While autograd records
(training, ``inplace=False``) every cache write makes new tensors instead:
a layer's saved view of a stacked cache must never be overwritten by the
next layer's write.

The paged plane writes each step's K/V rows straight into the shared pool
with an in-place ``index_put_`` (the reference's ``kp.at[pg, slot].set``)
and attends with the ``paged_decode`` kernel (one token per row) or the
``flash_prefill_paged`` kernel (a prefill chunk); on the CPU, their plain
versions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN
from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.models.layers import is_dtensor, pin_grad, rmsnorm
from repro_torch.models.rope import apply_rope

_NEG = -1e30

#: Sharding hooks of the dry run (``launch/steps.py`` sets them; serving and
#: training leave them None and pay one None check). ``FLASH_KV_SPEC``: the
#: DTensor placements the flash path lays its K/V (B, T, Hkv, D) and its
#: grouped queries (B, S, Hkv, G, D) out in before the chunk loops (batch
#: on ``data``, heads on ``model`` where they divide), the reference's
#: ``FLASH_KV_SPEC``: no chunk re-gathers a sharded sequence.
FLASH_KV_SPEC = None


def _split(t, dim: int, parts: tuple):
    """``t`` with dim ``dim`` viewed as ``parts`` (a head view)."""
    if is_dtensor(t):
        t = _even_heads(t, dim, parts[0])
    return t.reshape(t.shape[:dim] + parts + t.shape[dim + 1:])


def _meet_keys(qg, k):
    """The dry run's direct path: queries (B, S, Hkv, G, D) replicated on
    ``model`` unless the keys (B, T, Hkv, D) shard their heads there too
    (a decode cache shards its sequence on ``model``)."""
    from torch.distributed.tensor import Replicate
    ax = k.device_mesh.mesh_dim_names.index("model")
    if k.placements[ax].is_shard(2) and qg.placements[ax].is_shard(2):
        return qg
    pl = list(qg.placements)
    pl[ax] = Replicate()
    return qg.redistribute(placements=pl)


def _merge(t, shape):
    """``t`` with its head dims merged into ``shape``. In the dry run the
    merged tensor is re-laid out as it is (a no-op forward) so that its
    gradient, arriving sharded over the merged dim, is laid out as ``t``'s
    before the backward unflattens it."""
    return pin_grad(t.reshape(shape))


def _even_heads(t, dim: int, heads: int):
    """A head view's DTensor with each dim sharded where ``heads`` would
    split unevenly (8 KV heads on a 16-way axis) replicated there first,
    which GSPMD does silently and DTensor refuses to."""
    from torch.distributed.tensor import Replicate
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if p.is_shard(dim) and heads % t.device_mesh.size(i):
            pl[i] = Replicate()
    return t.redistribute(placements=pl) if pl != list(t.placements) else t


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
    """The reference's ``_flash_fwd_impl``: online softmax over kv chunks,
    one q chunk at a time. Returns (o (B, Sq, Hkv, G, D) in v's dtype,
    lse (B, Hkv, G, Sq) fp32)."""
    B, Sq, Hkv, G, D = qg.shape
    Tk = k.shape[1]
    Cq = _pick_chunk(Sq, q_chunk)
    Ck = _pick_chunk(Tk, kv_chunk)
    outs, lses = [], []
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
        lden = torch.clamp(lden, min=1e-30)
        outs.append((acc / lden[..., None]).permute(0, 3, 1, 2, 4).to(v.dtype))
        lses.append(m + torch.log(lden))                     # (B,Hkv,G,Cq)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd(qg, k, v, q_pos, k_pos, o, lse, do, window, softcap,
               q_chunk, kv_chunk):
    """The reference's ``_flash_bwd_impl``: recompute each block's
    probabilities from (q, k, lse), ``Drow = sum(do * o)``, the softcap's
    chain rule ``ds *= 1 - tanh^2``; dq per q chunk, dk/dv accumulated
    over q chunks, all in fp32. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, Hkv, G, D = qg.shape
    Tk = k.shape[1]
    Cq = _pick_chunk(Sq, q_chunk)
    Ck = _pick_chunk(Tk, kv_chunk)
    dk = torch.zeros((B, Tk, Hkv, D), dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for q0 in range(0, Sq, Cq):
        qb = qg[:, q0:q0 + Cq].float()
        qp = q_pos[:, q0:q0 + Cq]
        dob = do[:, q0:q0 + Cq].float()
        drow = torch.einsum("bqhgd,bqhgd->bhgq", dob,
                            o[:, q0:q0 + Cq].float())
        lseb = lse[..., q0:q0 + Cq, None]
        dq_b = torch.zeros_like(qb)
        for k0 in range(0, Tk, Ck):
            kb, vb = k[:, k0:k0 + Ck].float(), v[:, k0:k0 + Ck].float()
            s_raw = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
            mask = _block_mask(qp, k_pos[:, k0:k0 + Ck], window)
            s = torch.where(mask, _softcap(s_raw, softcap), _NEG)
            p = torch.exp(s - lseb) * mask                  # (B,H,G,Cq,Ck)
            dv[:, k0:k0 + Ck] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - drow[..., None])
            if softcap:
                t = torch.tanh(s_raw / softcap)
                ds = ds * (1.0 - t * t)
            dq_b += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
            dk[:, k0:k0 + Ck] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
        dqs.append(dq_b)
    return (torch.cat(dqs, dim=1).to(qg.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Differentiable ``_flash`` (the reference's ``custom_vjp``): the
    forward saves only its inputs, ``o`` and ``lse``, never a chunk's
    scores; the backward is ``_flash_bwd``. The integer positions get no
    gradient."""

    @staticmethod
    def forward(ctx, qg, k, v, q_pos, k_pos, window, softcap, q_chunk,
                kv_chunk):
        o, lse = _flash(qg, k, v, q_pos, k_pos, window, softcap, q_chunk,
                        kv_chunk)
        ctx.save_for_backward(qg, k, v, q_pos, k_pos, o, lse)
        ctx.args = (window, softcap, q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        qg, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(qg, k, v, q_pos, k_pos, o, lse, do,
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, softcap=None,
              scale=None, q_chunk: int = 1024, kv_chunk: int = 2048,
              force_flash: bool | None = None):
    """q: (B,Sq,Hq,D); k/v: (B,Tk,Hkv,D); returns (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _split(q * (scale if scale is not None else D ** -0.5), 2, (Hkv, G))
    use_flash = force_flash if force_flash is not None else (
        Sq * Tk > 4096 * 2048)

    def attend(qg, k, v, q_pos, k_pos):
        if use_flash:
            return _FlashAttention.apply(qg, k, v, q_pos, k_pos, window,
                                         softcap, q_chunk, kv_chunk)
        return _direct(qg, k, v, q_pos, k_pos, window, softcap)

    if FLASH_KV_SPEC is not None:
        o = _local(attend, qg, k, v, q_pos, k_pos)
    else:
        if is_dtensor(k) and is_dtensor(qg):
            qg = _meet_keys(qg, k)
        o = attend(qg, k, v, q_pos, k_pos)
    return _merge(o, (B, Sq, Hq, D))


def _local(attend, qg, k, v, q_pos, k_pos):
    """The dry run's prefill/train attention: queries, keys and values laid
    out by ``FLASH_KV_SPEC`` (batch on ``data``, heads on ``model``), the
    positions by its batch part, and ``attend`` run on each rank's shards
    (``local_map``): attention is independent per (row, head), so no
    collective runs inside it and no chunk re-gathers a sharded dim."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    pos_pl = tuple(p if p.is_shard(0) else Replicate()
                   for p in FLASH_KV_SPEC)

    def placed(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(placements=pos_pl)

    fn = local_map(attend, out_placements=list(FLASH_KV_SPEC),
                   in_placements=(FLASH_KV_SPEC,) * 3 + (pos_pl,) * 2,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(qg, k, v, placed(q_pos), placed(k_pos))


# ======================================================================
# Paged decode attention (shared-pool data plane)

PAGED_CACHE_KEYS = ("k_pages", "v_pages", "block_tables")


def paged_decode_rows(q, k, v, k_pages, v_pages, block_tables, pos, *,
                      softcap=None, rows=None):
    """One decode token per row: write each row's K/V into its page slot of
    the shared pool IN PLACE, then attend over the row's block table.

    q: (N, Hq, D); k/v: (N, Hkv, D) post-rope; k/v_pages: (P, page, Hkv, D);
    block_tables: (N, npages) int32; pos: (N,) int32 position of the token.
    rows: None (every row is real) or an int32/int64 device tensor of the
    indices of the rows that write the pool, so rows padded into a batch
    write nothing (sentinel page 0 stays zero); they still attend, over
    sentinel page 0, and nothing reads their outputs. An index may repeat
    (the fused plane pads ``rows`` to a fixed length with the first real
    row's index): duplicates carry identical values, so ``index_put_`` is
    deterministic. Written pages are private per sequence (fresh decode
    pages, or the handoff's copy-on-write clone), so distinct rows never
    collide."""
    page = k_pages.shape[1]
    bt, pos_w = block_tables, pos
    if rows is not None:
        k, v = k.index_select(0, rows), v.index_select(0, rows)
        bt, pos_w = bt.index_select(0, rows), pos.index_select(0, rows)
    pos_l = pos_w.long()
    pg = bt.gather(1, (pos_l // page)[:, None])[:, 0].long()
    slot = pos_l % page
    k_pages.index_put_((pg, slot), k)
    v_pages.index_put_((pg, slot), v)
    # rope hands q back head-major; merging a one-model axis into the rows
    # keeps that layout as a view, which the kernel does not take
    return paged_decode_attention(q.contiguous(), k_pages, v_pages,
                                  block_tables, pos + 1,
                                  softcap=softcap or 0.0)


def _paged_apply(p, q, k, v, cache, pos, cfg):
    """Scatter the incoming tokens' K/V into their (private) pool pages IN
    PLACE, then attend over the block table. q/k/v: post-rope (B, S, H, D).

    S == 1 is the decode step (``paged_decode``); S > 1 is a prefill chunk
    (``flash_prefill_paged``). Both read the prefix straight from the
    pages, with no dense gather. The write precedes the attention, so every
    query finds its own key."""
    B, S = q.shape[0], q.shape[1]
    kp, vp, bt = (cache[key] for key in PAGED_CACHE_KEYS)
    if S == 1:
        o = paged_decode_rows(q[:, 0], k[:, 0], v[:, 0], kp, vp, bt, pos,
                              softcap=cfg.attn_softcap)
    else:
        page = kp.shape[1]
        positions = pos.long()[:, None] + torch.arange(S, device=pos.device)
        # written pages are private per sequence (fresh chunk pages, or a
        # partially filled page this request owns), so (pg, slot) never
        # collide
        pg = bt.gather(1, positions // page).long()              # (B, S)
        kp.index_put_((pg, positions % page), k)
        vp.index_put_((pg, positions % page), v)
        # the reference's paged_prefill_attention: q rows at start + i
        o = flash_prefill_paged(q.contiguous(), kp, vp, bt, pos,
                                softcap=cfg.attn_softcap or 0.0)
    return o.reshape(B, S, -1) @ p["wo"], cache


# ======================================================================
# Attention block: projections + rope + cache plumbing


def attn_init(ini, cfg, *, cross: bool = False, layers: int = 0):
    """The reference's ``attn_init`` tree from the seeded initializer
    ``ini`` (``models.model._Init``); a cross-attention block has no
    qk-norm."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ini.dense((d, hq * hd), layers=layers),
         "wk": ini.dense((d, hkv * hd), layers=layers),
         "wv": ini.dense((d, hkv * hd), layers=layers),
         "wo": ini.dense((hq * hd, d), layers=layers)}
    if cfg.qk_norm and not cross:
        p["q_norm"] = ini.zeros((hd,), layers=layers)
        p["k_norm"] = ini.zeros((hd,), layers=layers)
    return p


def init_attn_cache(cfg, kind, batch, cache_len, dtype, device, lead=()):
    """Dense KV cache of one layer, with a FLATTENED (Hkv * D) feature dim:
    ``{"k", "v": (batch, t, Hkv * D), "kpos": (batch, t)}``, ``kpos = -1``
    for an unwritten slot. A sliding-window layer keeps ``t = min(cache_len,
    window)`` rows."""
    t = cache_len
    if kind == LOCAL_ATTN and cfg.sliding_window:
        t = min(cache_len, cfg.sliding_window)
    shape = lead + (batch, t, cfg.n_kv_heads * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kpos": torch.full(lead + (batch, t), -1, dtype=torch.int32,
                               device=device)}


def _update_global(cache, k, v, q_pos, inplace: bool = True):
    """Write (B, S, f) rows at positions ``q_pos = pos + arange(S)`` into the
    dense cache. As the reference's ``dynamic_update_slice``, a write that
    would run past the cache's end is moved back to end there (its start is
    clamped to ``T - S``); ``kpos`` records the true positions. In place,
    or (``inplace=False``, while autograd records) into new tensors,
    returned as a new ``{"k", "v", "kpos"}``."""
    B, S = q_pos.shape
    T = cache["k"].shape[1]
    if inplace and is_dtensor(cache["k"]):
        return _update_sharded(cache, k, v, q_pos)
    start = torch.clamp(q_pos[:, :1].long(), 0, T - S)
    rows = start + torch.arange(S, device=q_pos.device)
    idx = (torch.arange(B, device=rows.device)[:, None].expand(B, S), rows)
    if not inplace:
        return {"k": cache["k"].index_put(idx, k),
                "v": cache["v"].index_put(idx, v),
                "kpos": cache["kpos"].index_put(idx, q_pos)}
    cache["k"].index_put_(idx, k)
    cache["v"].index_put_(idx, v)
    cache["kpos"].index_put_(idx, q_pos)
    return cache


def _update_sharded(cache, k, v, q_pos):
    """``_update_global`` in place on DTensors (the dry run), where an
    indexed write into a sharded dim has no sharding rule: a prefill that
    fills the whole cache is a copy, a one-token decode a masked select
    (the slot of each row's clamped position), both elementwise."""
    T, S = cache["k"].shape[1], q_pos.shape[1]
    new = {"k": k, "v": v, "kpos": q_pos}
    if S == 1:
        slot = torch.arange(T, device=q_pos.device)[None] == torch.clamp(
            q_pos.long(), 0, T - 1)                                # (B, T)
        new = {key: torch.where(slot[..., None] if val.dim() == 3 else slot,
                                val, cache[key])
               for key, val in new.items()}
    elif S != T:
        raise NotImplementedError(
            "a sharded cache takes whole-cache prefills and one-token decodes")
    for key, val in new.items():
        cache[key].copy_(val)
    return cache


def _update_window(cache, k, v, q_pos, inplace: bool = True):
    """A sliding-window cache keeps the LAST ``t`` keys (in place, or as a
    new dict with ``inplace=False``). As in the reference, a chunk of
    ``s >= t`` tokens leaves only its own last ``t`` keys, and the layer
    then attends over this cache alone, so the chunk's early queries lose
    keys inside their window (a reference behaviour the port keeps)."""
    t = cache["k"].shape[1]
    s = k.shape[1]
    if s >= t:
        new = {"k": k[:, -t:], "v": v[:, -t:], "kpos": q_pos[:, -t:]}
    else:
        new = {"k": torch.cat([cache["k"][:, s:], k], dim=1),
               "v": torch.cat([cache["v"][:, s:], v], dim=1),
               "kpos": torch.cat([cache["kpos"][:, s:], q_pos], dim=1)}
    if not inplace:
        return new
    for key in ("k", "v", "kpos"):
        cache[key].copy_(new[key])
    return cache


def project_qkv(p, x, cfg, q_pos):
    """q/k/v projections, optional qk-norm and rope. x: (B, S, d);
    q_pos: (B, S). Returns q (B,S,Hq,D), k and v (B,S,Hkv,D)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split(x @ p["wq"], 2, (hq, hd))
    k = _split(x @ p["wk"], 2, (hkv, hd))
    v = _split(x @ p["wv"], 2, (hkv, hd))
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, q_pos, style=cfg.rope_style, theta=cfg.rope_theta)
    k = apply_rope(k, q_pos, style=cfg.rope_style, theta=cfg.rope_theta)
    return q, k, v


def _cross_apply(p, q, cfg, cache, enc_out, inplace: bool = True):
    """Cross-attention over the encoder output: prefill (``enc_out`` given)
    computes the encoder K/V and writes them into the cross cache (with
    ``inplace=False``: returns them as a new cross cache), decode
    (``enc_out=None``) reads them back. Every query sees every key
    (``q_pos`` is int32's max). An empty cross cache (an enc-dec model
    served on tokens alone) gives zero attention outputs, as in the
    reference."""
    B, S = q.shape[:2]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if enc_out is not None:
        kf, vf = enc_out @ p["wk"], enc_out @ p["wv"]
        if not inplace:
            cache = {"k": kf, "v": vf}
        elif cache is not None:
            cache["k"].copy_(kf)
            cache["v"].copy_(vf)
    else:
        kf, vf = cache["k"], cache["v"]
    k = _split(kf, 2, (hkv, hd))
    v = _split(vf, 2, (hkv, hd))
    tk = k.shape[1]
    q_pos = torch.full((B, S), torch.iinfo(torch.int32).max,
                       dtype=torch.int32, device=q.device)
    k_pos = torch.arange(tk, dtype=torch.int32,
                         device=q.device)[None].expand(B, tk)
    o = attention(q, k, v, q_pos, k_pos)
    return _merge(o, (B, S, hq * hd)) @ p["wo"], cache


def attn_apply(p, x, cfg, kind=ATTN, *, cache=None, pos=None, enc_out=None,
               cross: bool = False, causal: bool = True,
               inplace: bool = True):
    """One attention layer. x: (B, S, D); pos: (B,) starting absolute
    position of x's first token; cache: dense or paged cache dict, or None
    (self-attention over x alone; ``causal=False`` lets every query see
    every key, the encoder's case). ``kind=LOCAL_ATTN`` attends within
    ``cfg.sliding_window``; ``cross=True`` is the decoder's block over the
    encoder output. Returns (out, cache): caches are updated in place, or,
    with ``inplace=False`` (the functional path, taken while autograd
    records), a dense cache's new tensors come back in a new dict and no
    tensor is written."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == LOCAL_ATTN else 0
    if cross:
        q = _split(x @ p["wq"], 2, (hq, hd))
        return _cross_apply(p, q, cfg, cache, enc_out, inplace)
    if pos is None:
        pos = torch.zeros((B,), dtype=torch.int32, device=x.device)
    q_pos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                        device=x.device)[None, :]
    q, k, v = project_qkv(p, x, cfg, q_pos)

    if cache is not None and "k_pages" in cache:
        if kind == LOCAL_ATTN:
            raise NotImplementedError("paged cache requires global attention")
        return _paged_apply(p, q, k, v, cache, pos, cfg)

    if cache is None:
        mask_qpos = q_pos if causal else torch.full_like(
            q_pos, torch.iinfo(torch.int32).max)
        o = attention(q, k, v, mask_qpos, q_pos, window=window,
                      softcap=cfg.attn_softcap)
    else:
        kf, vf = k.reshape(B, S, hkv * hd), v.reshape(B, S, hkv * hd)
        if kind == LOCAL_ATTN and cfg.sliding_window:
            cache = _update_window(cache, kf, vf, q_pos, inplace)
        else:
            cache = _update_global(cache, kf, vf, q_pos, inplace)
        o = attention(q, _split(cache["k"], 2, (hkv, hd)),
                      _split(cache["v"], 2, (hkv, hd)), q_pos, cache["kpos"],
                      window=window, softcap=cfg.attn_softcap)
    return _merge(o, (B, S, hq * hd)) @ p["wo"], cache
