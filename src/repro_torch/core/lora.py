"""LoRA adapters and parameter stacking for the fused decode plane.

Port of ``repro.core.lora`` without its training loss
(``cache_conditioned_lora_loss`` comes with the training code).

Adapter trees mirror the base param tree: every targeted weight position
holds a ``LoRAPair`` (A, B), every other position holds None.
Classification is positional: ``lora_apply`` pairs each base LEAF with the
adapter tree's node at the same position, and only a ``LoRAPair`` (or a
bare two-key ``{"A", "B"}`` dict of tensors) there is an adapter, so a real
param subtree that merely has keys A/B is never taken for one. Two ways to
consume adapters:
  - ``lora_apply`` materializes ``W + (alpha/rank) * A @ B`` (the per-model
    ``fused=False`` path);
  - the fused plane stacks only the A/B factors (``stack_lora_params``) and
    merges each lane's targeted weights one layer at a time inside its step
    (``lora_lanes``), through the same 2-D ``lora_delta`` call, so the
    merged weights are bit-equal to ``lora_apply``'s.

Stacked weights are the fused plane's layout, and this module owns it. Two
kinds of member trees stack:
  - trees built one by one (``init_params``, ``params_from_numpy``):
    ``torch.stack`` copies them, as the reference does;
  - rows of ONE tree built stacked (``models.init_stacked_params`` then
    ``unstack_params``), which is how full-width decoders fit one card.
    Consecutive rows come back as a slice of that tree, never as a copy.
    Any other mix raises, because the copy would sit beside the stacked
    tree that the rows keep alive (16 GB per Llama-3.1-8B decoder).
``model_axis_order`` puts rows of a stacked tree in row order, so the names
the decoders are registered under do not matter; the registry calls
``check_stackable`` before it changes its model set.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.params import tree_leaves, tree_map

DEFAULT_TARGETS = ("wq", "wv", "wo")


class LoRAPair(NamedTuple):
    """One adapter: ``delta = scale * A @ B``."""
    A: Any
    B: Any


def _walk(fn, base, other, name=None):
    """Map ``fn(leaf, node, name)`` over ``base``'s leaves, where ``node`` is
    ``other``'s whole subtree at the same position (None where ``other`` has
    nothing) and ``name`` is the leaf's dict key: the reference's
    ``flatten_up_to`` pairing, base leaves driving."""
    if isinstance(base, dict):
        return {k: _walk(fn, v, None if other is None else other[k], k)
                for k, v in base.items()}
    if isinstance(base, (list, tuple)):
        return type(base)(_walk(fn, v, None if other is None else other[i])
                          for i, v in enumerate(base))
    return fn(base, other, name)


def lora_init(base_params, *, rank: int = 8, targets=DEFAULT_TARGETS,
              generator: torch.Generator | None = None) -> Any:
    """A/B pairs (A ~ N(0, 1) / rank, B = 0) for every targeted weight of
    two or more dimensions, None elsewhere. Seed ``generator`` for
    reproducible adapters (torch cannot reproduce ``jax.random``; parity
    tests carry the reference's adapters across with
    ``params.adapters_from_numpy``)."""
    def init(w, _, name):
        if w.dim() < 2 or name not in targets:
            return None
        *batch, m, n = w.shape
        a = torch.randn((*batch, m, rank), generator=generator,
                        dtype=torch.float32, device=w.device) / rank
        b = torch.zeros((*batch, rank, n), dtype=torch.float32,
                        device=w.device)
        return LoRAPair(a.to(w.dtype), b.to(w.dtype))
    return _walk(init, base_params, None)


def _pair(ab):
    """``ab`` as an adapter pair, else None: a ``LoRAPair``, or a bare
    two-key {"A", "B"} dict of tensors (unambiguous at a base LEAF
    position)."""
    if isinstance(ab, LoRAPair):
        return ab
    if isinstance(ab, dict) and set(ab) == {"A", "B"} \
            and all(isinstance(x, torch.Tensor) for x in ab.values()):
        return LoRAPair(ab["A"], ab["B"])
    return None


def lora_delta(ab: LoRAPair, scale: float):
    """The low-rank update ``scale * A @ B`` in float32."""
    return (ab.A.float() @ ab.B.float()) * scale


def _merge(w, ab: LoRAPair, scale: float):
    """``(W + scale * A @ B)`` in W's dtype, one 2-D ``lora_delta`` per
    matrix: a stacked layer axis is merged layer by layer, so the result
    is bit-equal to ``lora_lanes``' per-layer merge."""
    if w.dim() > 2:
        return torch.stack([_merge(w[i], LoRAPair(ab.A[i], ab.B[i]), scale)
                            for i in range(w.shape[0])])
    return (w.float() + lora_delta(ab, scale)).to(w.dtype)


def lora_apply(base_params, lora_params, *, alpha: float = 16.0,
               rank: int = 8):
    """Materialize effective params: ``W + (alpha/rank) * A @ B`` at every
    adapter position; every other base leaf is passed through (the same
    tensor, no copy)."""
    scale = alpha / rank

    def merge(w, ab, _):
        pair = _pair(ab)
        return w if pair is None else _merge(w, pair, scale)
    return _walk(merge, base_params, lora_params)


def lora_lanes(layer_params, layer_adapters, scale: float):
    """One layer's weights for M adapter lanes (the fused plane's in-step
    merge): each targeted weight becomes ``(M, ...)``, lane m's
    ``W + scale * A[m] @ B[m]`` through the same 2-D ``lora_delta`` call
    ``lora_apply`` makes; every other weight is the base's, with no model
    axis. ``layer_adapters``: the layer's adapters, stacked on a leading
    model axis (``stack_lora_params``)."""
    def merge(w, ab, _):
        pair = _pair(ab)
        if pair is None:
            return w
        out = torch.empty((len(pair.A),) + tuple(w.shape), dtype=w.dtype,
                          device=w.device)
        for m, (a, b) in enumerate(zip(pair.A, pair.B)):
            out[m] = _merge(w, LoRAPair(a, b), scale)   # one lane's temps
        return out
    return _walk(merge, layer_params, layer_adapters)


def check_layer_adapters(lora_params) -> None:
    """Raise unless every adapter of ``lora_params`` sits on a layer's
    weight: the fused plane merges per layer and reads ``embed``,
    ``unembed`` and ``final_norm`` from the base."""
    outside = [k for k in lora_params if k not in ("groups", "tail")
               and tree_leaves(lora_params[k])]
    if outside:
        raise NotImplementedError(
            f"adapters on {outside}: the fused decode plane merges adapters "
            f"of the layers' weights only (fused=False serves any target)")


def lora_param_count(lora_params) -> int:
    return sum(x.numel() for x in tree_leaves(lora_params))


def stack_lora_params(lora_list):
    """``stack_params`` for adapter trees: stack only the A/B factors on a
    new leading model axis; None positions stay None. Raises if the models'
    targeted-weight sets differ."""
    if not lora_list:
        raise ValueError("need at least one adapter tree to stack")
    try:
        return tree_map(lambda *xs: torch.stack(xs), *lora_list)
    except (TypeError, KeyError, ValueError, RuntimeError) as e:
        raise ValueError(
            f"cannot stack adapters: targeted-weight sets differ across the "
            f"{len(lora_list)} models ({e})") from e


def _row_of(x):
    """``(base, row)`` when ``x`` is row ``row`` of a contiguous tensor
    stacked on a leading axis, else None."""
    base = x._base
    if (base is None or not base.is_contiguous()
            or tuple(base.shape[1:]) != tuple(x.shape)
            or tuple(x.stride()) != tuple(base.stride()[1:])):
        return None
    row, rem = divmod(x.storage_offset() - base.storage_offset(),
                      base.stride(0))
    return (base, row) if rem == 0 and 0 <= row < base.shape[0] else None


def stack_row(tree):
    """Row of the stacked tree that ``tree`` is a view of (read from its
    first leaf), or None for a tree built on its own."""
    r = _row_of(tree_leaves(tree)[0])
    return None if r is None else r[1]


def model_axis_order(trees) -> list:
    """Indices of ``trees`` in model-axis order: rows of stacked trees by
    row first, then trees built on their own, in the order given."""
    rows = [stack_row(t) for t in trees]
    return sorted(range(len(trees)),
                  key=lambda i: (rows[i] is None, rows[i] or 0))


def _plan(xs):
    """How one leaf of every member (in model-axis order) stacks: None to
    copy them, or ``(base, first)`` for the view ``base[first:first + n]``.
    Raises for rows of stacked trees that are not consecutive rows of one."""
    rows = [_row_of(x) for x in xs]
    if all(r is None for r in rows):
        return None
    if rows[0] is not None:
        base, first = rows[0]
        if all(r is not None and r[0].data_ptr() == base.data_ptr()
               and r[0].shape == base.shape and r[1] == first + m
               for m, r in enumerate(rows)):
            return base, first
    raise ValueError(
        "stack_params: these decoders include rows of a stacked tree "
        "(init_stacked_params) that are not consecutive rows of one tree, so "
        "stacking them would copy every member beside the tree the rows keep "
        "alive; register consecutive rows of one init_stacked_params tree, "
        "or decoders built one by one")


def _stack_leaf(*xs):
    plan = _plan(xs)
    if plan is None:
        return torch.stack(xs)
    base, first = plan
    return base[first:first + len(xs)]


def stack_params(param_list):
    """Stack structurally identical param trees on a NEW leading model axis:
    N decode modules sharing one ModelConfig become one tree whose every leaf
    is (N, ...), so one forward advances sequences of all N models."""
    if not param_list:
        raise ValueError("need at least one param tree to stack")
    return tree_map(_stack_leaf, *param_list)


def check_stackable(trees) -> None:
    """Raise what ``stack_params`` would raise for ``trees`` put in model-axis
    order, without stacking anything."""
    if trees:
        ordered = [trees[i] for i in model_axis_order(trees)]
        tree_map(lambda *xs: _plan(xs), *ordered)


def unstack_params(stacked, n_models: int) -> list:
    """Per-model views ``[tree[m] for m]`` of a stacked tree (no copy)."""
    return [tree_map(lambda x, m=m: x[m], stacked) for m in range(n_models)]
