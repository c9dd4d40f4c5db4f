"""Chunk-prefill attention straight over the shared KV pool: the Hopper
kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill_paged.py``
(``flash_prefill_paged``). The CUDA source is ``csrc/flash_prefill_paged.cu``;
its header note gives the design and what bounds it on the card. On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
the plain version in ``kernels/ref.py``. There is no fallback between them.
Off the CPU, shapes and types are checked before the device, so each
refusal names its cause.

In bf16 at head_dim 64 and above the kernel runs on the tensor cores and may
split each row tile's key range into parts (``choose_splits``), whose
partial results a second kernel merges (``kernels.ref.ref_merge_splits`` is
its plain version); the wrapper allocates their scratch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_prefill

_SIGNATURE = {"flash_prefill_paged_launch": [ctypes.c_void_p] * 8
              + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16
#: the tensor-core kernel's tiles: 64 flat query rows, 64 keys
ROW_TILE = KEY_TILE = 64
#: most parts a key range is split into (the merge kernel's bound)
MAX_SPLITS = 16


def choose_splits(B: int, S: int, Hq: int, Hkv: int, key_capacity: int,
                  sms: int) -> int:
    """Parts to split each row tile's keys into, so that the grid fills the
    card. The tensor-core kernel runs B * Hkv * ceil(G * S / 64) blocks
    (G = Hq // Hkv); when that is at least ``sms`` it returns 1. Otherwise
    it returns the least n that reaches ``sms`` blocks, at most
    ``MAX_SPLITS`` and at most the key tiles of a table of
    ``key_capacity`` keys (npages * page: the most keys a row can see, since
    the chunk's start stays on the card), so that no part is planned under
    one key tile."""
    blocks = B * Hkv * math.ceil((Hq // Hkv) * S / ROW_TILE)
    if blocks >= sms:
        return 1
    return max(1, min(math.ceil(sms / blocks), MAX_SPLITS,
                      math.ceil(key_capacity / KEY_TILE)))


def flash_prefill_paged(q, k_pages, v_pages, block_tables, start, *,
                        softcap: float = 0.0, scale: float | None = None,
                        splits: int | None = None):
    """Chunk-prefill attention over a paged KV pool.

    q:            (B, S, Hq, D) chunk queries; q[b, i] sits at absolute
                  position ``start[b] + i``
    k/v_pages:    (P, page, Hkv, D) physical pools; the chunk's own K/V rows
                  must already be in their pages
    block_tables: (B, npages) int32 logical -> physical page ids (columns
                  past a sequence's last page may hold sentinel page 0)
    start:        (B,) int32 absolute position of each chunk's first token
    splits:       parts of each row tile's key range on the tensor-core
                  path (default ``choose_splits``; a test forces it); must
                  be 1 or None elsewhere. The CPU path ignores it.
    returns       (B, S, Hq, D) in q's dtype
    """
    if q.device.type == "cpu":
        return ref_paged_prefill(q, k_pages, v_pages, block_tables, start,
                                 softcap=softcap, scale=scale)
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
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_paged: unsupported device {q.device}")
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
    if q.dtype == torch.bfloat16 and D >= 64:       # the tensor-core path
        n = splits or choose_splits(B, S, Hq, Hkv, npages * page,
                                    _build.sm_count(q.device))
    else:
        n = splits or 1
        if n != 1:
            raise ValueError(f"flash_prefill_paged: splits={n}; only the "
                             f"bf16 kernel at head_dim >= 64 splits")
    if not 1 <= n <= MAX_SPLITS or B * n > 65535:
        raise ValueError(f"flash_prefill_paged: splits={n} (1..{MAX_SPLITS}"
                         f", B * splits <= 65535)")
    out = torch.empty_like(q)
    part_o = part_ml = None
    if n > 1:
        part_o = torch.empty((n, B * S * Hq, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((2, n, B * S * Hq), dtype=torch.float32,
                              device=q.device)
    lib = _build.LIBRARIES.get("flash_prefill_paged", _SIGNATURE)
    err = lib.flash_prefill_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if n > 1 else None,
        part_ml.data_ptr() if n > 1 else None,
        B, S, Hq, Hkv, D, page, npages, n,
        float(D ** -0.5 if scale is None else scale), float(softcap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_paged")
    flash_prefill_paged.launches += 1
    return out


#: kernel launches since the last reset (the CPU path does not count)
flash_prefill_paged.launches = 0
