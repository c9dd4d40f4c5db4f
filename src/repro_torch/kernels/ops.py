"""Public wrappers for the port's kernels, in the model's layout.

Port of ``repro.kernels.ops``. There is no ``interpret`` argument: the
tensors' device decides. On a CUDA tensor each call launches its Hopper
kernel or raises; on a CPU tensor it runs the kernel's plain version.
Nothing is built at import time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import flash_prefill_into
from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
from repro_torch.kernels.paged_decode import paged_decode_attention


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """Model-layout wrapper of ``flash_prefill``: q (B, S, Hq, D), k/v
    (B, T, Hkv, D) -> (B, S, Hq, D). Query i sits at position i and key j
    at j (relative, aligned top-left). The kernel reads the inputs and
    writes the output through transposed views: nothing is copied."""
    B, S, Hq, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    flash_prefill_into(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), out.transpose(1, 2), causal=causal,
                       window=window, softcap=softcap, scale=scale)
    return out


def paged_prefill(q, k_pages, v_pages, block_tables, start, *,
                  softcap: float = 0.0, scale: float | None = None):
    """Chunk-prefill attention over the paged pool: q (B, S, Hq, D) at
    absolute positions ``start[b] + i`` attends to prefix + chunk straight
    from the pages (no dense gather of the prefix)."""
    return flash_prefill_paged(q, k_pages, v_pages, block_tables, start,
                               softcap=softcap, scale=scale)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    softcap: float = 0.0, scale: float | None = None):
    """Single-token decode attention over the paged pool: q (B, Hq, D)
    against the first ``lengths[b]`` keys of each block table."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                  softcap=softcap, scale=scale)
