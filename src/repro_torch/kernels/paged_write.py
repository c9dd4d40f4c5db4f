"""Scatter freshly prefilled K/V into the paged pool: the Hopper kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_write.py``
(``paged_write``). The CUDA source is ``csrc/paged_write.cu``. The pools are
updated in place (the TPU version aliased input and output buffers to the
same effect).

The TPU kernel kept its page axis sequential in case two grid points wrote
one pool page. GPU blocks run in parallel in no order, so this wrapper takes
the block tables and valid-page counts on the HOST (numpy or a CPU tensor,
which is where the engine builds them), checks that the valid target pages
are unique, raises if they are not, and only then uploads them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_write

_SIGNATURE = {"paged_write_launch": [ctypes.c_void_p] * 6
              + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_void_p]}


def valid_targets(block_tables: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """The pool pages a write touches: ``block_tables[b, j]``, j < n_valid[b].
    Raises if two of them name one pool page."""
    npages = block_tables.shape[1]
    targets = block_tables[n_valid[:, None] > np.arange(npages)[None]]
    if len(np.unique(targets)) != len(targets):
        vals, counts = np.unique(targets, return_counts=True)
        raise ValueError(f"paged_write: target pages written more than once: "
                         f"{vals[counts > 1].tolist()}")
    return targets


def paged_write(new_k, new_v, k_pages, v_pages, block_tables, n_valid):
    """Write per-request new KV rows into their assigned physical pages.

    new_k/new_v:  (B, npages * page, Hkv, D) fresh KV, contiguous
    k/v_pages:    (P, page, Hkv, D) physical pools, updated in place
    block_tables: (B, npages) int physical page per logical page (host)
    n_valid:      (B,) int number of valid pages per request (host)
    returns the (same) pools
    """
    bt = np.ascontiguousarray(np.asarray(block_tables, np.int32))
    nv = np.ascontiguousarray(np.asarray(n_valid, np.int32))
    B, S, Hkv, D = new_k.shape
    page = k_pages.shape[1]
    npages = S // page
    if npages * page != S or bt.shape != (B, npages) or nv.shape != (B,):
        raise ValueError(f"paged_write: rows {tuple(new_k.shape)}, page "
                         f"{page}, tables {bt.shape}, n_valid {nv.shape}")
    if (nv < 0).any() or (nv > npages).any():
        raise ValueError(f"paged_write: n_valid {nv.tolist()} out of "
                         f"[0, {npages}]")
    valid = valid_targets(bt, nv)
    if new_k.device.type == "cpu":
        return ref_paged_write(new_k, new_v, k_pages, v_pages, bt, nv)
    if new_k.device.type != "cuda":
        raise ValueError(f"paged_write: unsupported device {new_k.device}")
    tensors = (new_k, new_v, k_pages, v_pages)
    if any(t.device != new_k.device for t in tensors):
        raise ValueError("paged_write: all tensors must be on one device")
    if any(t.dtype != new_k.dtype for t in tensors) \
            or new_v.shape != new_k.shape or v_pages.shape != k_pages.shape \
            or k_pages.shape[2:] != new_k.shape[2:]:
        raise ValueError("paged_write: shapes/dtypes of rows and pools differ")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("paged_write: tensors must be contiguous and "
                         "16-byte aligned")
    page_bytes = page * Hkv * D * new_k.element_size()
    if page_bytes % 16:
        raise ValueError(f"paged_write: page of {page_bytes} bytes is not a "
                         f"multiple of 16")
    if valid.size and (valid.min() < 0 or valid.max() >= k_pages.shape[0]):
        raise ValueError("paged_write: target page id out of pool range")
    dev = new_k.device
    launch_on_device_tables(new_k, new_v, k_pages, v_pages,
                            torch.from_numpy(bt).to(dev),
                            torch.from_numpy(nv).to(dev))
    return k_pages, v_pages


def launch_on_device_tables(new_k, new_v, k_pages, v_pages, bt_d, nv_d):
    """Launch the kernel on tables already on the card. ``paged_write``
    checks its arguments (unique targets above all) and then calls this;
    called directly, it times the kernel without the host check and the
    uploads."""
    B, S, Hkv, D = new_k.shape
    page = k_pages.shape[1]
    lib = _build.LIBRARIES.get("paged_write", _SIGNATURE)
    err = lib.paged_write_launch(
        new_k.data_ptr(), new_v.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), bt_d.data_ptr(), nv_d.data_ptr(), B, S // page,
        page * Hkv * D * new_k.element_size(),
        torch.cuda.current_stream(new_k.device).cuda_stream)
    _build.check(err, "paged_write")
    paged_write.launches += 1


#: kernel launches since the last reset (the CPU path does not count)
paged_write.launches = 0
