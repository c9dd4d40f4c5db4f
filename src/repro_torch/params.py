"""Parameter trees: carry the reference's weights across, and tree helpers.

A parameter tree is the reference's layout in plain Python containers:
nested dicts (and the ``tail`` list) of tensors, with the same keys, the
same shapes and the same stacked leading ``n_full`` axis on ``groups``.
torch cannot reproduce ``jax.random``, so every parity test builds weights
once in the reference and carries them here as numpy arrays
(``params_from_numpy``), or through the ``.npz`` + ``.json`` checkpoint the
reference's ``training/checkpoint.py`` writes (``load_npz``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of structurally identical trees. None is
    an empty node, as in jax (an adapter tree's untargeted positions), and
    stays None."""
    t0 = trees[0]
    if t0 is None:
        if any(t is not None for t in trees):
            raise ValueError("tree structures differ: None against a node")
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        mapped = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*mapped) if hasattr(t0, "_fields") \
            else type(t0)(mapped)               # NamedTuple (LoRAPair)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves`` sorts dict keys
    and drops None)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch.from_numpy
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))        # writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """The reference's parameter tree, as numpy arrays, -> the port's tree of
    tensors on ``device`` (the card by default). Keys, shapes and the stacked
    leading axis are kept; ``dtype`` optionally casts floating leaves."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev, dtype), tree)


def adapters_from_numpy(tree, device=None, dtype: torch.dtype | None = None):
    """A reference adapter tree (``lora_init``'s layout: a ``LoRAPair`` or an
    ``{"A", "B"}`` dict at each targeted weight, None elsewhere, leaves as
    numpy arrays) -> the port's, with ``core.lora.LoRAPair`` at the targeted
    positions, on ``device`` (the card by default)."""
    # imported here: core.lora imports this module (tree_map)
    from repro_torch.core.lora import LoRAPair
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        pair = None
        if getattr(node, "_fields", None) == ("A", "B"):
            pair = tuple(node)
        elif isinstance(node, dict) and set(node) == {"A", "B"}:
            pair = (node["A"], node["B"])
        if pair is not None and all(hasattr(a, "shape") for a in pair):
            return LoRAPair(*(_to_tensor(a, dev, dtype) for a in pair))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        raise TypeError(f"not an adapter tree node: {type(node)}")
    return conv(tree)


def load_npz(path: str) -> dict:
    """Read a reference checkpoint (``repro.training.checkpoint.save``) into
    a numpy parameter tree. Keys are "/"-joined paths; integer path parts
    index the ``tail`` list. bf16 leaves were stored as f32."""
    stem = path.removesuffix(".npz")
    with open(stem + ".json") as f:
        keys = json.load(f)["keys"]
    tree: dict = {}
    with np.load(stem + ".npz") as npz:
        for key in keys:
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = npz[key]
    tree = _lists(tree)
    if "embed" in tree:                    # empty containers leave no keys
        tree.setdefault("groups", {})
        tree.setdefault("tail", [])
    return tree


def _lists(node):
    """Turn dicts keyed "0".."n-1" (a list's checkpoint paths) into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
