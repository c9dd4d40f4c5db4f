"""Chunk-prefill attention straight over the shared KV pool: the Hopper
kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill_paged.py``
(``flash_prefill_paged``). The CUDA source is ``csrc/flash_prefill_paged.cu``;
its header note gives the design and what bounds it on the card. On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
the plain version in ``kernels/ref.py``. There is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_prefill

_SIGNATURE = {"flash_prefill_paged_launch": [ctypes.c_void_p] * 6
              + [ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8


def flash_prefill_paged(q, k_pages, v_pages, block_tables, start, *,
                        softcap: float = 0.0, scale: float | None = None):
    """Chunk-prefill attention over a paged KV pool.

    q:            (B, S, Hq, D) chunk queries; q[b, i] sits at absolute
                  position ``start[b] + i``
    k/v_pages:    (P, page, Hkv, D) physical pools; the chunk's own K/V rows
                  must already be in their pages
    block_tables: (B, npages) int32 logical -> physical page ids (columns
                  past a sequence's last page may hold sentinel page 0)
    start:        (B,) int32 absolute position of each chunk's first token
    returns       (B, S, Hq, D) in q's dtype
    """
    if q.device.type == "cpu":
        return ref_paged_prefill(q, k_pages, v_pages, block_tables, start,
                                 softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_paged: unsupported device {q.device}")
    B, S, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    npages = block_tables.shape[1]
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"flash_prefill_paged: q {tuple(q.shape)} vs pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_paged: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"flash_prefill_paged: dtypes {q.dtype}/"
                         f"{k_pages.dtype}/{v_pages.dtype}; need one of f32, "
                         f"bf16")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_prefill_paged: Hq={Hq} Hkv={Hkv} (query "
                         f"group <= {MAX_GROUP})")
    tensors = (q, k_pages, v_pages, block_tables, start)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_prefill_paged: all inputs must be on one "
                         "device")
    if any(not t.is_contiguous() for t in tensors) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("flash_prefill_paged: inputs must be contiguous, "
                         "pools 16-byte aligned")
    if block_tables.dtype != torch.int32 or start.dtype != torch.int32 \
            or tuple(start.shape) != (B,) or block_tables.shape[0] != B:
        raise ValueError("flash_prefill_paged: block_tables (B, npages) and "
                         "start (B,) must be int32")
    out = torch.empty_like(q)
    lib = _build.LIBRARIES.get("flash_prefill_paged", _SIGNATURE)
    err = lib.flash_prefill_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, D, page, npages,
        float(D ** -0.5 if scale is None else scale), float(softcap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_paged")
    flash_prefill_paged.launches += 1
    return out


#: kernel launches since the last reset (the CPU path does not count)
flash_prefill_paged.launches = 0
