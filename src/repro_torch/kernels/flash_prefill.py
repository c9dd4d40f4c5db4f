"""Dense flash attention for the prefill stage: the Hopper kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py``
(``flash_prefill``). The CUDA source is ``csrc/flash_prefill.cu``; its
header note gives the design and what bounds it on the card. On a CUDA
tensor the wrapper launches that kernel or raises; on a CPU tensor it runs
the plain version ``ref_flash_prefill`` in ``kernels/ref.py``. There is no
fallback between them.

The kernel reads q, k, v and writes the output through their (batch, head,
row) strides, so ``ops.flash_attention`` hands it the model's seq-major
layout as transposed views and nothing is copied. Each row must have unit
stride on D and start 16 bytes aligned.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_prefill

_SIGNATURE = {"flash_prefill_launch": [ctypes.c_void_p] * 4
              + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 8
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float | None = None,
                  block_q: int = 512, block_k: int = 512):
    """Dense GQA flash attention, head-major.

    q:       (B, Hq, S, D); query i sits at position i
    k/v:     (B, Hkv, T, D); key j sits at position j (any S and T)
    causal:  key j visible to query i only if j <= i
    window:  if > 0, key j visible to query i only if j > i - window
    softcap: if > 0, scores become tanh(s / softcap) * softcap
    scale:   default D ** -0.5
    returns  (B, Hq, S, D) in q's dtype; a row with no visible key is 0

    ``block_q`` and ``block_k`` are accepted for the reference's signature
    and do not change the result: the Pallas kernel's tiles only change its
    rounding, and the CUDA kernel picks its own.
    """
    B, Hq, S, D = q.shape
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    return flash_prefill_into(q, k, v, out, causal=causal, window=window,
                              softcap=softcap, scale=scale)


def _row_strides(t) -> list:
    """(batch, head, row) strides of a (B, H, N, D) tensor, 0 for a
    dimension of size 1 (never stepped over)."""
    return [t.stride(i) if t.shape[i] > 1 else 0 for i in range(3)]


def flash_prefill_into(q, k, v, out, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, scale: float | None = None):
    """``flash_prefill`` writing into ``out`` (B, Hq, S, D), which may be a
    strided view (``ops.flash_attention`` passes the seq-major output
    transposed). Returns ``out``. On any device but the CPU, shapes and
    types are checked before the device, so each refusal names its cause."""
    if q.device.type == "cpu":
        out.copy_(ref_flash_prefill(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale))
        return out
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or out.shape != q.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}; need q/out (B, Hq, S, D) and "
                         f"k/v (B, Hkv, T, D)")
    B, Hq, S, D = q.shape
    Bk, Hkv, T, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, out)):
        raise ValueError(f"flash_prefill: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of f32, bf16")
    if Hkv <= 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_prefill: Hq={Hq} Hkv={Hkv} (query group "
                         f"<= {MAX_GROUP})")
    if int(window) < 0:
        raise ValueError(f"flash_prefill: window {window} < 0")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    tensors = (q, k, v, out)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_prefill: all inputs must be on one device")
    item = q.element_size()
    if any(t.stride(3) != 1 or t.data_ptr() % 16
           or any(s * item % 16 for s in _row_strides(t)) for t in tensors):
        raise ValueError("flash_prefill: each row needs unit stride on D and "
                         "a 16-byte aligned start")
    lib = _build.LIBRARIES.get("flash_prefill", _SIGNATURE)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_row_strides(q), *_row_strides(k), *_row_strides(v),
        *_row_strides(out), B, S, T, Hq, Hkv, D, int(bool(causal)),
        int(window), float(D ** -0.5 if scale is None else scale),
        float(softcap or 0.0), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


#: kernel launches since the last reset (the CPU path does not count)
flash_prefill.launches = 0
