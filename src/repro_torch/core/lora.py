"""Parameter stacking for the fused decode plane.

Port of ``repro.core.lora.stack_params``. LoRA adapters (``lora_init``,
``lora_apply`` and the stacked-adapter merge) arrive with the serving
features slice.

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

import torch

from repro_torch.params import tree_leaves, tree_map


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
