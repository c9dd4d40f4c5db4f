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
