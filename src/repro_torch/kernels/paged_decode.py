"""Paged decode attention over the shared KV pool: the Hopper kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_decode.py``
(``paged_decode_attention``). The CUDA source is ``csrc/paged_decode.cu``;
its header note gives the design and what bounds it on the card. On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
the plain version in ``kernels/ref.py``. There is no fallback between them.
Off the CPU, shapes and types are checked before the device, so each
refusal names its cause.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_decode

_SIGNATURE = {"paged_decode_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           softcap: float = 0.0, scale: float | None = None):
    """Single-token decode attention over a paged KV pool.

    q:            (B, Hq, D) current-step queries
    k/v_pages:    (P, page, Hkv, D) physical pools
    block_tables: (B, npages) int32 logical -> physical page ids
    lengths:      (B,) int32 valid KV length per sequence
    returns       (B, Hq, D) in q's dtype
    """
    if q.device.type == "cpu":
        return ref_paged_decode(q, k_pages, v_pages, block_tables, lengths,
                                softcap=softcap, scale=scale)
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    npages = block_tables.shape[1]
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} vs pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode: dtypes {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}; need one of f32, bf16")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_decode: Hq={Hq} Hkv={Hkv} (query group "
                         f"<= {MAX_GROUP})")
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode: all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: inputs must be contiguous, pools "
                         "16-byte aligned")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B:
        raise ValueError("paged_decode: block_tables (B, npages) and "
                         "lengths (B,) must be int32")
    out = torch.empty_like(q)
    lib = _build.LIBRARIES.get("paged_decode", _SIGNATURE)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, page, npages,
        float(D ** -0.5 if scale is None else scale), float(softcap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the last reset (the CPU path does not count)
paged_decode_attention.launches = 0
