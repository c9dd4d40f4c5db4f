"""Collective traffic, flops and live bytes of one step, per device.

The counterpart of ``repro.launch.hloanalysis``. The reference parses
the compiled HLO of a sharded step; torch has no HLO, so this module
watches the step run instead: ``StepRecorder`` is a ``TorchDispatchMode``
that sees every operation DTensor issues on each rank's local shards, as
the reference's post-SPMD HLO holds per-device shapes. The mapping:

  HLO op (reference)            torch op (``_c10d_functional``)
  all-gather                    all_gather_into_tensor[_coalesced]
  all-reduce                    all_reduce[_coalesced]
  reduce-scatter                reduce_scatter_tensor[_coalesced]
  all-to-all                    all_to_all_single (``_dtensor``:
                                shard_dim_alltoall)
  collective-permute            broadcast, permute_tensor

Byte semantics are the reference's (per-device link traffic):
  all-gather         : result bytes (already includes the group factor)
  all-reduce         : 2 x bytes (ring reduce-scatter + all-gather)
  reduce-scatter     : input volume (result bytes x group size)
  all-to-all         : result bytes
  collective-permute : result bytes

The reference multiplies each collective by the trip counts of the while
loops around it (``cost_analysis`` counts a scan body once). Eager torch
runs every layer's collective, so nothing is multiplied and ``loops`` is
empty. On a mesh of CPU devices DTensor reshards between two sharded dims
with an all-gather and a local chunk (it warns "CPU process group does not
support alltoall"), so such a reshard is counted as an all-gather here.

The recorder also sums the flops of every local operation (the
``torch.utils.flop_counter`` formulas: matrix products, attention,
convolutions) and follows the bytes of every storage the step allocates,
for the step's peak of live temporaries.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def collective_bytes_of(kind: str, inputs, result) -> float:
    """Per-device bytes one collective moves, by the reference's rules."""
    if kind == "all-reduce":
        return 2.0 * _nbytes(result)
    if kind == "reduce-scatter":
        return float(_nbytes(inputs))
    return float(_nbytes(result))


class StepRecorder(TorchDispatchMode):
    """Records, on this rank's local tensors while active: every collective
    (``records``: kind and bytes), the flops (``flops``) and the peak bytes
    of storages allocated inside (``peak_bytes``; storages of ``exclude``,
    the step's arguments, are not counted). With DTensors it defers each
    operation to DTensor (which then issues its local operations and
    collectives through this mode) and skips DTensor's own shape
    propagation, which runs operations at global shapes."""

    def __init__(self, exclude=(), sharded: bool = True):
        super().__init__()
        self.sharded = sharded
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.records: list = []
        self.flops = 0
        self.live: dict = {st._cdata: 0 for st in
                           (t.untyped_storage() for t in _tensors(
                               list(exclude)))}
        self.cur = self.peak_bytes = 0
        self._propagating = 0

    def __enter__(self):
        if not self.sharded:
            return super().__enter__()
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._prop_cls = ShardingPropagator
        self._prop_fn = orig = ShardingPropagator.__dict__[
            "_propagate_tensor_meta_non_cached"]

        def counted(prop, *a, **kw):
            self._propagating += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self._propagating -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = counted
        return super().__enter__()

    def __exit__(self, *exc):
        if self.sharded:
            self._prop_cls._propagate_tensor_meta_non_cached = self._prop_fn
        return super().__exit__(*exc)

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)

    def _allocated(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata in self.live:
                continue
            n = st.nbytes()
            self.live[st._cdata] = n
            weakref.finalize(st, self._free, st._cdata)
            self.cur += n
        self.peak_bytes = max(self.peak_bytes, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.sharded:
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        packet = func._overloadpacket
        kind = _KINDS.get(packet.__name__) \
            if func.namespace in ("_c10d_functional", "_dtensor") else None
        if kind is not None:
            self.records.append({
                "op": kind, "bytes": collective_bytes_of(kind, args[0], out)})
        elif packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        self._allocated(out)
        return out


def collective_bytes(records) -> dict:
    """Per-device collective totals of a recorded step: ``{"by_op",
    "counts", "total", "loops"}`` as the reference's ``analyze``."""
    totals: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for r in records:
        totals[r["op"]] += r["bytes"]
        counts[r["op"]] += 1
    return {"by_op": dict(totals), "counts": dict(counts),
            "total": float(sum(totals.values())), "loops": []}
