"""Rule-based sharding policy, as DTensor placements.

``param_pspec`` and ``cache_pspec`` are the reference's rules
(``repro.launch.sharding``), copied: Megatron-style tensor parallelism on
the ``model`` axis (column-parallel ``wi/wu/wq/wk/wv``: output features on
``model``; row-parallel ``wo/out_proj``: the reduction dim on ``model``),
FSDP of the other large dim over ``data``, every rule divisibility-checked
against the mesh so no shard is uneven. Caches: batch over ``data`` when it
divides, else the KV sequence (context parallelism for a batch of one);
heads or head_dim on ``model``; a decode cache shards its KV sequence on
``model`` (the flash-decode layout). They take plain ints and return a
tuple with one entry per tensor dim: an axis name, a tuple of axis names,
or None.

``params_shardings``, ``cache_shardings`` and ``batch_sharding`` turn each
leaf's spec into the placements of a ``DeviceMesh`` (one ``Shard(d)`` or
``Replicate()`` per mesh dim, ``data`` standing for ``(pod, data)`` on a
multi-pod mesh); ``distribute`` lays a tree of shape-only tensors out as
DTensors with them.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.params import tree_map

ROW_PARALLEL = ("wo", "out_proj", "out")   # reduction dim sharded on model


def param_pspec(name: str, shape, data: int, model: int) -> tuple:
    nd = len(shape)
    if nd <= 1:
        return ()
    leaf = name.rsplit("/", 1)[-1]
    axes = [None] * nd
    # embeddings: vocab on model (keeps chunked-CE logits vocab-sharded)
    if leaf in ("embed", "unembed"):
        if shape[0] % model == 0:
            axes[0] = "model"
            if shape[1] % data == 0:
                axes[1] = "data"
        elif shape[1] % model == 0:
            axes[1] = "model"
        return tuple(axes)
    row = any(leaf == r or leaf.endswith(r) for r in ROW_PARALLEL)
    prefer, other = (nd - 2, nd - 1) if row else (nd - 1, nd - 2)
    if shape[prefer] % model == 0:
        axes[prefer] = "model"
    elif shape[other] % model == 0:
        axes[other] = "model"
        prefer, other = other, prefer
    if axes[other] is None and shape[other] % data == 0:
        axes[other] = "data"
    return tuple(axes)


def cache_pspec(name: str, shape, data: int, model: int, *,
                stacked: bool, decode: bool = False) -> tuple:
    nd = len(shape)
    axes = [None] * nd
    off = 1 if stacked else 0      # leading layer-group dim never sharded
    leaf = name.rsplit("/", 1)[-1]
    dims = list(range(off, nd))
    if not dims:
        return ()
    b = dims[0]
    if shape[b] % data == 0 and shape[b] > 1:
        axes[b] = "data"
    elif len(dims) > 1 and leaf in ("k", "v", "kpos") \
            and shape[dims[1]] % data == 0:
        axes[dims[1]] = "data"     # context parallelism (batch=1 long decode)
    if decode and leaf in ("k", "v", "kpos") and len(dims) > 1:
        # flash-decode layout: the KV sequence on `model`; one query token
        # contracts over it, so the softmax combines are small reductions
        s = dims[1]
        if axes[s] is None and shape[s] % model == 0:
            axes[s] = "model"
            return tuple(axes)
        if axes[s] == "data" and shape[s] % (data * model) == 0:
            axes[s] = ("data", "model")
            return tuple(axes)
    # model axis: try trailing dims (heads, then head_dim/state)
    for d in (dims[2:] if leaf in ("k", "v") else dims[1:]):
        if axes[d] is None and shape[d] % model == 0 and shape[d] >= model:
            axes[d] = "model"
            break
    return tuple(axes)


def _expand_data(spec: tuple, mesh) -> tuple:
    """Replace 'data' with the composite (pod, data) axes on multi-pod
    meshes."""
    das = data_axes(mesh)
    if das == ("data",):
        return spec
    return tuple(das if a == "data" else a for a in spec)


def _total_data(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def placements(spec: tuple, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim for a spec: mesh
    dim ``name`` shards the tensor dim whose entry names it (a tuple entry
    splits its dim over several mesh dims, major first, as the mesh's
    own order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def _paths(tree, prefix=""):
    """(the reference's "/"-joined path, leaf) of every leaf, with the
    same tree shape out (path strings at the leaves)."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return prefix[:-1]


def params_shardings(param_shapes, mesh, *, fsdp: bool = True):
    """Placements for every leaf of a params (or optimizer-state) tree.

    ``fsdp=False`` drops the ``data``-axis shard on weights (pure tensor
    parallelism, weights replicated across data rows): inference steps
    take it when the tensor-parallel shard fits a card, since FSDP's
    per-layer weight all-gather dominates decode traffic."""
    model = axis_size(mesh, "model")
    data = _total_data(mesh)

    def one(path, leaf):
        spec = param_pspec(path, tuple(leaf.shape), data, model)
        if not fsdp:
            spec = tuple(a if a != "data" else None for a in spec)
        return placements(_expand_data(spec, mesh), mesh)

    return tree_map(one, _paths(param_shapes), param_shapes)


def cache_shardings(cache_shapes, mesh, *, decode: bool = False):
    model = axis_size(mesh, "model")
    data = _total_data(mesh)

    def one(path, leaf):
        spec = cache_pspec(path, tuple(leaf.shape), data, model,
                           stacked=path.startswith("groups"), decode=decode)
        return placements(_expand_data(spec, mesh), mesh)

    return tree_map(one, _paths(cache_shapes), cache_shapes)


def batch_sharding(shape, mesh, *, axes: str = "data") -> tuple:
    """(B, ...) arrays: batch over the data axes (``axes="data"``) or over
    the WHOLE mesh (``axes="all"``)."""
    names = (data_axes(mesh) + ("model",)) if axes == "all" \
        else data_axes(mesh)
    n = 1
    for a in names:
        n *= axis_size(mesh, a)
    spec = ()
    if shape and shape[0] % n == 0 and shape[0] > 1:
        spec = (names,) + (None,) * (len(shape) - 1)
    elif shape and shape[0] % _total_data(mesh) == 0 and shape[0] > 1:
        spec = (data_axes(mesh),) + (None,) * (len(shape) - 1)
    return placements(spec, mesh)


def distribute(tree, placement_tree, mesh):
    """Lay out a tree of shape-only tensors (meta, or fake under a
    ``FakeTensorMode``) as DTensors of the given placements: each rank's
    local shard has the shape those placements give it. None stays None.
    Under a ``FakeTensorMode`` nothing is allocated."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        if t.device.type == "meta":
            t = torch.empty(t.shape, dtype=t.dtype)
        return distribute_tensor(t, mesh, list(pl))

    def walk(t, pl):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        if isinstance(t, (list, tuple)):
            items = [walk(a, b) for a, b in zip(t, pl)]
            return type(t)(*items) if hasattr(t, "_fields") \
                else type(t)(items)
        return one(t, pl)

    return walk(tree, placement_tree)
