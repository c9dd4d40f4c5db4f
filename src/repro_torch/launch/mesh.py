"""Production meshes on H100s, over a fake process group.

The reference lays its steps out on TPU v5e pods (16x16 chips, two pods
for 512). The port keeps the chip counts and lays them out on HGX nodes of
8 H100s: a ``(32, 8)`` ``("data", "model")`` mesh is 32 nodes with tensor
parallelism inside each node's NVLink domain (the ``model`` axis never
crosses InfiniBand, and 8-way splits every config's GQA heads evenly);
``(2, 32, 8)`` adds a ``pod`` axis. No card is touched: the process group
is ``torch.distributed``'s fake backend (one process plays every rank,
collectives do nothing), which is what lets ``launch/dryrun.py`` lay fake
tensors out on 256 or 512 ranks. The process group is made on the first
call, never at import.
"""
from __future__ import annotations

PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def _fake_world(world_size: int) -> None:
    """Initialize the fake process group of ``world_size`` ranks (this
    process is rank 0), or check the one already made."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"this mesh needs {world_size}")
        return
    # the fake backend's store is not public API; this is its one import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _mesh(shape, names):
    import math

    from torch.distributed.device_mesh import init_device_mesh
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """``(32, 8)`` ``("data", "model")``, or ``(2, 32, 8)`` ``("pod",
    "data", "model")`` with ``multi_pod``: 256 or 512 fake ranks."""
    return _mesh(*PRODUCTION_SHAPES[multi_pod])


def make_host_mesh(model: int = 1, n: int | None = None, pod: int = 1):
    """A ``(n // model, model)`` ``("data", "model")`` mesh over ``n`` fake
    ranks: the process group's size if one exists, else 1 (CPU tests).
    ``pod > 1`` adds a leading ``pod`` axis, as on the multi-pod production
    mesh: ``(pod, n // (pod * model), model)``."""
    if n is None:
        import torch.distributed as dist
        n = dist.get_world_size() if dist.is_initialized() else 1
    if pod > 1:
        return _mesh((pod, n // (pod * model), model),
                     ("pod", "data", "model"))
    return _mesh((n // model, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    if name not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]
