"""Paged decode attention over the shared KV pool: the Hopper kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_decode.py``
(``paged_decode_attention``). The CUDA source is ``csrc/paged_decode.cu``;
its header note gives the design and what bounds it on the card. On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
the plain version in ``kernels/ref.py``. There is no fallback between them.
Off the CPU, shapes and types are checked before the device, so each
refusal names its cause.

In bf16 at head_dim 64 and above the kernel runs on the tensor cores and
splits each sequence's keys into parts (``choose_splits``, from shapes
alone: the lengths stay on the card and nothing is read back), whose
partial results a second kernel merges (``kernels.ref.ref_merge_splits`` is
its plain version); the wrapper allocates their scratch. The call does not
synchronise with the host.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_decode

_SIGNATURE = {"paged_decode_launch": [ctypes.c_void_p] * 8
              + [ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16
#: keys per tile of the tensor-core kernel: the unit a key range is split in
KEY_TILE = 64
#: most parts a key range is split into (the merge kernel's bound)
MAX_SPLITS = 16
#: key tiles of the table's capacity a part is planned over, at least: the
#: engine buckets tables to the next power of two of the pages in use, so a
#: part then sees about half to all of these
MIN_PART_TILES = 8


def choose_splits(B: int, Hkv: int, key_capacity: int, sms: int) -> int:
    """Parts to split each sequence's keys into, from shapes alone (the
    lengths stay on the card). The tensor-core kernel runs B * Hkv * n
    blocks. 1 when B * Hkv blocks leave at most a sixteenth of the ``sms``
    SMs idle; otherwise the most parts that still run in one wave of two
    blocks an SM (two fit at head_dim 128), at most ``MAX_SPLITS`` and at
    most one part per ``MIN_PART_TILES`` key tiles of a table of
    ``key_capacity`` keys (npages * page), so that no part is planned under
    that many tiles. A part's fixed costs (its first loads' latency, the
    combine of its warps, its share of the merge) outweigh the streaming of
    fewer keys: ``python -m repro_torch.launch.decode_splits`` measures the
    device time against n on the card (PERF.md)."""
    blocks = max(1, B * Hkv)
    if blocks >= sms - sms // 16:
        return 1
    return max(1, min(2 * sms // blocks, MAX_SPLITS,
                      math.ceil(key_capacity / (KEY_TILE * MIN_PART_TILES))))


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           softcap: float = 0.0, scale: float | None = None,
                           splits: int | None = None):
    """Single-token decode attention over a paged KV pool.

    q:            (B, Hq, D) current-step queries
    k/v_pages:    (P, page, Hkv, D) physical pools
    block_tables: (B, npages) int32 logical -> physical page ids
    lengths:      (B,) int32 valid KV length per sequence
    splits:       parts of each sequence's key range on the tensor-core path
                  (default ``choose_splits``; a test forces it); must be 1
                  or None elsewhere. The CPU path ignores it.
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
    tc = q.dtype == torch.bfloat16 and D >= 64      # the tensor-core path
    if splits is not None and not (1 <= splits <= MAX_SPLITS
                                   and (tc or splits == 1)):
        raise ValueError(f"paged_decode: splits={splits} (1..{MAX_SPLITS}; "
                         f"only the bf16 kernel at head_dim >= 64 splits)")
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode: all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 \
            or (tc and q.data_ptr() % 16):
        raise ValueError("paged_decode: inputs must be contiguous, the "
                         "pools (and q in bf16) 16-byte aligned")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (B,) or block_tables.shape[0] != B:
        raise ValueError("paged_decode: block_tables (B, npages) and "
                         "lengths (B,) must be int32")
    n = splits or (choose_splits(B, Hkv, npages * page,
                                 _build.sm_count(q.device)) if tc else 1)
    out = torch.empty_like(q)
    part_o = part_ml = None
    if n > 1:
        part_o = torch.empty((n, B * Hq, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((2, n, B * Hq), dtype=torch.float32,
                              device=q.device)
    lib = _build.LIBRARIES.get("paged_decode", _SIGNATURE)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_o.data_ptr() if n > 1 else None,
        part_ml.data_ptr() if n > 1 else None,
        B, Hq, Hkv, D, page, npages, n,
        float(D ** -0.5 if scale is None else scale), float(softcap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the last reset, one per call whether or not the
#: parts are merged (the CPU path does not count)
paged_decode_attention.launches = 0
