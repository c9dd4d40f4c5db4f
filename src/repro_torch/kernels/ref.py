"""Plain PyTorch versions of the port's kernels.

They restate ``repro.kernels.ref`` op for op. The CPU tests run them (a
kernel wrapper takes them for tensors that lie on the CPU), and
``chip_smoke.py`` holds each Hopper kernel against them on the card.
"""
from __future__ import annotations

import torch

NEG = -1e30

#: How closely a bf16 ``paged_decode`` kernel must match ``ref_paged_decode``
#: at the main path's decode shape (Hq 32, Hkv 8, D 128, 1k-4k tokens; unit
#: normal inputs give outputs of about 0.03). One bf16 rounding step at any
#: magnitude (at most 2**-7 of the value) passes; one wrong 16-token page, or
#: one key too many, moves some output by 2e-2 or more and fails. The
#: reference kernel tests' 2e-2 stays for their small cases.
MAIN_SHAPE_BF16_TOL = {"atol": 1e-3, "rtol": 1e-2}

#: How closely a bf16 ``flash_prefill_paged`` kernel must match
#: ``ref_paged_prefill`` at the main path's chunk shapes (Hq 32, Hkv 8,
#: D 128, page 16; 200-token chunks at starts 0-800 and 4 x 40-token chunks
#: at start 992). Both sides accumulate in fp32 and round once to bf16, so
#: one bf16 rounding step (at most 2**-7 of the value) passes; one wrong
#: page, one key too many past the causal boundary, or a ``start`` one too
#: small moves some output by more and fails
#: (``tests/test_torch_kernels.py``). The reference kernel tests' 2e-2
#: stays for their small cases.
MAIN_SHAPE_PREFILL_BF16_TOL = {"atol": 1e-3, "rtol": 1e-2}

#: How closely a bf16 ``flash_prefill`` kernel must match
#: ``ref_flash_prefill`` at the full-width dense shapes (Llama-3.1-8B: Hq 32,
#: Hkv 8, D 128, causal, S = T = 1000 and 8192; Gemma-2-27B: Hq 32, Hkv 16,
#: window 4096, softcap 50). Both sides accumulate in fp32 and round once to
#: bf16, so a result rounded another way (fp64) passes; the window one key
#: too wide, the causal boundary one key too far, a query group reading the
#: wrong kv head, or the softcap skipped moves some output by more and
#: fails (``tests/test_torch_kernels.py``, at a narrow copy of that
#: structure). The reference kernel tests' 2e-2 stays for their small cases.
MAIN_SHAPE_FLASH_BF16_TOL = {"atol": 1e-3, "rtol": 1e-2}

#: ``ref_flash_prefill`` materialises its scores in blocks of query rows of
#: at most this many fp32 elements (1 GiB), so full-width shapes fit beside
#: the kernel's inputs on the card
_FLASH_REF_BLOCK = 1 << 28


def ref_flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: float | None = None):
    """Dense GQA attention with materialised scores, head-major.

    q: (B, Hq, S, D); k/v: (B, Hkv, T, D). Returns (B, Hq, S, D) in q's
    dtype. Positions are relative and aligned top-left: query i sits at
    position i and key j at j, also when S != T. Key j is visible to query
    i iff j <= i (``causal``) and j > i - window (``window`` > 0). The op
    order is ``repro.kernels.ref.ref_flash_prefill``'s: q to fp32 times
    ``scale``, the score einsum, the softcap, the mask, the softmax, the
    value einsum in fp32. One difference: a row with no visible key gives
    0, as the Pallas kernel ``repro.kernels.flash_prefill`` does (its
    denominator stays 0), where the reference's oracle gives mean(v). The
    scores are materialised in blocks of query rows (a softmax row never
    spans two), at most ``_FLASH_REF_BLOCK`` elements each."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    kpos = torch.arange(T, device=q.device)[None, :]
    rows = max(1, _FLASH_REF_BLOCK // max(1, B * Hq * T))
    out = torch.empty((B, Hkv, g, S, D), dtype=q.dtype, device=q.device)
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        qg = q[:, :, s0:s1].reshape(B, Hkv, g, s1 - s0, D).float() * scale
        s = torch.einsum("bhgsd,bhtd->bhgst", qg, kf)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        mask = torch.ones((s1 - s0, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgst,bhtd->bhgsd", p, vf)
        o = torch.where(mask.any(dim=-1)[:, None], o, 0.0)
        out[:, :, :, s0:s1] = o.to(q.dtype)
    return out.reshape(B, Hq, S, D)


def ref_paged_decode(q, k_pages, v_pages, block_tables, lengths, *,
                     softcap: float = 0.0, scale: float | None = None):
    """Gather pages into contiguous KV, then masked softmax attention.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_tables: (B, npages)
    int32; lengths: (B,) int32. Returns (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    npages = block_tables.shape[1]
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    bt = block_tables.long()
    T = npages * page
    k = k_pages[bt].reshape(B, T, Hkv, D)
    v = v_pages[bt].reshape(B, T, Hkv, D)

    qg = q.reshape(B, Hkv, g, D).float() * scale
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = (torch.arange(T, device=q.device)[None]
            < lengths.to(q.device)[:, None])               # (B, T)
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def ref_paged_prefill(q, k_pages, v_pages, block_tables, start, *,
                      softcap: float = 0.0, scale: float | None = None):
    """Chunk-prefill attention over pages: gather the block table into
    contiguous KV, then a materialized causal softmax at absolute positions
    (q[b, i] sits at ``start[b] + i``; key t is visible iff t <= that).

    q: (B, S, Hq, D); k/v_pages: (P, page, Hkv, D); block_tables: (B,
    npages) int32; start: (B,) int32. Returns (B, S, Hq, D) in q's dtype.
    The op order is the reference's (scale, reshape, score einsum, softcap,
    mask, softmax, value einsum), which is ``_direct``'s, so chunked and
    dense prefill give the same greedy tokens."""
    B, S, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    npages = block_tables.shape[1]
    g = Hq // Hkv
    T = npages * page
    scale = D ** -0.5 if scale is None else scale
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, T, Hkv, D)
    v = v_pages[bt].reshape(B, T, Hkv, D)

    qg = (q.float() * scale).reshape(B, S, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = (start.to(q.device)[:, None]
            + torch.arange(S, dtype=torch.int32, device=q.device)[None])
    kpos = torch.arange(T, dtype=torch.int32, device=q.device)
    mask = kpos[None, None, None, None, :] <= qpos[:, None, None, :, None]
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)


def ref_merge_splits(o_parts, m_parts, l_parts):
    """Combine the parts of a key range split for ``flash_prefill_paged`` or
    ``paged_decode``.

    o_parts: (n, ..., D) fp32 unnormalised outputs (sum of exp(s - m) v over
    a part's visible keys); m_parts, l_parts: (n, ...) the part's running
    max (-1e30 where it saw no key) and denominator. Returns (..., D) fp32:
    sum_p w_p o_p / sum_p w_p l_p with w_p = exp(m_p - max_p m_p), and 0
    where that denominator is 0 (a row with no visible key in any part).
    The plain version of ``csrc/merge_splits.cuh:merge_splits_kernel``
    (before its rounding to the output's dtype)."""
    mx = m_parts.max(dim=0).values
    w = torch.exp(m_parts - mx)
    den = (w * l_parts).sum(dim=0)
    num = (w[..., None] * o_parts).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-30)[..., None], 0.0)


def ref_paged_write(new_k, new_v, k_pages, v_pages, block_tables, n_valid):
    """Scatter new KV rows into their assigned pages, in place.

    new_k/new_v: (B, npages * page, Hkv, D); k/v_pages: (P, page, Hkv, D);
    block_tables: (B, npages) and n_valid: (B,) on the host. Pages at or
    beyond ``n_valid[b]`` keep their contents."""
    B, S, Hkv, D = new_k.shape
    page = k_pages.shape[1]
    npages = S // page
    nk = new_k.reshape(B, npages, page, Hkv, D)
    nv = new_v.reshape(B, npages, page, Hkv, D)
    for b in range(B):
        for j in range(int(n_valid[b])):
            k_pages[int(block_tables[b][j])] = nk[b, j]
            v_pages[int(block_tables[b][j])] = nv[b, j]
    return k_pages, v_pages
