"""Checkpointing: a parameter (or any) tree <-> the reference's ``.npz``
plus ``.json`` manifest.

Port of ``repro.training.checkpoint``: keys are the leaves' paths joined
with "/" (dict keys sorted, list indices, ``.A``/``.B`` for an adapter
pair's fields, None skipped), bf16 leaves are stored as fp32, and the
manifest lists the keys beside a ``meta`` dict. Either package reads the
other's files.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.params import params_to_numpy, read_npz


def _map_keyed(fn, tree, prefix: str = ""):
    """Map ``fn(key, leaf)`` over ``tree``'s leaves, ``key`` the leaf's path
    in the reference's spelling; the tree's structure is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if hasattr(tree, "_fields"):                       # an adapter pair
        return type(tree)(*(_map_keyed(fn, getattr(tree, f), f"{prefix}.{f}/")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_keyed(fn, x, f"{prefix}{i}/")
                          for i, x in enumerate(tree))
    return fn(prefix[:-1], tree)


def save(path: str, tree, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keyed = {}
    _map_keyed(keyed.__setitem__, params_to_numpy(tree))
    np.savez(path if path.endswith(".npz") else path + ".npz", **keyed)
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump({"keys": sorted(keyed), "meta": meta or {}}, f)


def load(path: str, like):
    """Restore into the structure of ``like``, each leaf read at its path
    (shapes must match) and given ``like``'s dtype and device."""
    arrays = read_npz(path)

    def leaf(key, x):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(x.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(x.shape)}")
        return torch.from_numpy(np.array(arr)).to(x.device, x.dtype)

    return _map_keyed(leaf, like)
