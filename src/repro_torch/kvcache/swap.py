"""Host-memory KV swap tier: the data plane of preemption.

Port of ``repro.kvcache.swap``. Oversubscription (``serving/preempt.py``)
parks a low-priority decode sequence by moving its PRIVATE pages' KV off
the device: ``put`` gathers every selected page across all layer groups
(``index_select`` on the page axis) and copies the rows into pinned host
tensors with ``non_blocking=True``, then waits on a CUDA event; the pool
rows become SWAPPED (reclaimable: ``BlockPool.alloc`` may hand them to new
owners). On resume, rows that were never revoked reattach with zero data
movement; revoked ones are copied back from the pinned tensors and written
in place with ``index_copy_``, the in-place counterpart of the reference's
donated whole-pool scatter.

The reference has no Pallas kernel here, only a gather and a scatter: both
are data moves, so torch indexing and copies are their counterpart.

Page counts are bucketed to the next power of two, as in the reference:
the gather reads the bucket's width (pad slots index sentinel row 0, and
only the real rows travel to the host), and the restore writes the bucket's
width with the pad slots ZERO and aimed at row 0. Row 0 holds no KV and is
never read as live KV, and it stays all zeros: nothing but zeros is ever
written there.

Each transfer is timed on the host clock around an event synchronize and
fed to ``observe(nbytes, seconds)``, so the preemption cost model prices
swap against recompute from the measured link, not from a constant.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import synchronize


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the page-count shape bucket."""
    return 1 << max(0, int(n) - 1).bit_length()


def _leaves(state):
    """(key, index, tensor, page axis) for every tensor of a pool state:
    group tensors ``(n_full, P + 1, ...)`` page on axis 1, tail tensors
    ``(P + 1, ...)`` on axis 0."""
    for key in ("kg", "vg"):
        for g in sorted(state[key]):
            yield key, g, state[key][g], 1
    for key in ("kt", "vt"):
        for i, a in enumerate(state[key]):
            yield key, i, a, 0


def _host_empty(shape, dtype, device) -> torch.Tensor:
    """A host tensor for rows of a pool on ``device``: pinned when the pool
    is on the card (so the copy is asynchronous), plain otherwise."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def _wait(device) -> None:
    """Wait for the copies just issued: an event on the current stream."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


class HostSwapPool:
    """rid-keyed host-memory store of swapped-out page KV.

    ``put`` copies pages device -> host (timed, fed to the bandwidth
    model); ``restore`` writes a subset of an entry's pages back into fresh
    device rows; ``pop`` discards the host copy (resume complete, or abort
    while swapped). ``observe(nbytes, seconds)``, when given, receives every
    measured transfer."""

    def __init__(self, observe=None):
        self._entries: dict = {}      # rid -> {"bids": list, "host": dict}
        self.observe = observe
        self.total_bytes = 0

    def __contains__(self, rid) -> bool:
        return rid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def bids(self, rid):
        return self._entries[rid]["bids"]

    def entry_pages(self, rid) -> int:
        return len(self._entries[rid]["bids"])

    # ------------------------------------------------------------------
    def put(self, kvpool, rid, bids) -> int:
        """Copy pages ``bids`` (all layers) to host memory under ``rid``.
        One gather per pool tensor and one asynchronous copy of its real
        rows into pinned memory; returns the bytes moved."""
        assert rid not in self._entries, f"rid {rid} already swapped"
        n = len(bids)
        dev = kvpool.device
        width = next_pow2(n)
        idx = torch.tensor(list(bids) + [0] * (width - n), dtype=torch.long,
                           device=dev)
        host = {"kg": {}, "vg": {}, "kt": [], "vt": []}
        synchronize(dev)              # time the transfer, not earlier work
        t0 = time.perf_counter()
        for key, i, a, axis in _leaves(kvpool.pool_state()):
            rows = a.index_select(axis, idx).narrow(axis, 0, n)
            h = _host_empty(rows.shape, a.dtype, dev)
            h.copy_(rows, non_blocking=True)
            if axis:
                host[key][i] = h
            else:
                host[key].append(h)
        _wait(dev)
        dt = time.perf_counter() - t0
        nbytes = n * kvpool.page_bytes
        self._entries[rid] = {"bids": list(bids), "host": host,
                              "page_bytes": kvpool.page_bytes}
        self.total_bytes += nbytes
        if self.observe is not None and n:
            self.observe(nbytes, dt)
        return nbytes

    def restore(self, kvpool, rid, positions, dst_bids) -> int:
        """Write the entry's pages at ``positions`` back into device rows
        ``dst_bids``, in place; returns the bytes moved. Pages NOT in
        ``positions`` were never revoked and need no transfer."""
        entry = self._entries[rid]
        n = len(positions)
        if n == 0:
            return 0
        assert len(dst_bids) == n
        dev = kvpool.device
        width = next_pow2(n)
        idx = torch.tensor(list(dst_bids) + [0] * (width - n),
                           dtype=torch.long, device=dev)
        sel = torch.tensor(list(positions), dtype=torch.long)
        host = entry["host"]

        def pick(h, axis):
            # the page axis sized to the pow2 bucket up front: pad slots
            # stay zero and land on sentinel row 0, which holds only zeros
            shape = list(h.shape)
            shape[axis] = width
            out = _host_empty(shape, h.dtype, dev)
            out.zero_()
            out.narrow(axis, 0, n).copy_(h.index_select(axis, sel))
            return out

        vals = [pick(host[key][i], axis)
                for key, i, _, axis in _leaves(kvpool.pool_state())]
        synchronize(dev)
        t0 = time.perf_counter()
        for (_, _, a, axis), v in zip(_leaves(kvpool.pool_state()), vals):
            a.index_copy_(axis, idx, v.to(dev, non_blocking=True))
        _wait(dev)
        dt = time.perf_counter() - t0
        nbytes = n * kvpool.page_bytes
        if self.observe is not None:
            self.observe(nbytes, dt)
        return nbytes

    def pop(self, rid) -> None:
        """Discard ``rid``'s host copy (resume complete, or abort)."""
        entry = self._entries.pop(rid, None)
        if entry is not None:
            self.total_bytes -= len(entry["bids"]) * entry["page_bytes"]
