"""Stacked-layer trees: what the reference's ``lax.scan`` walks.

Layer parameters (and decode caches) are nested dicts of tensors stacked
on a leading layer axis, as in the reference. The port walks that axis
with a Python loop (``models.model``): ``tree_at`` takes one layer's
views out of a stacked tree (no copy, so an in-place update of a cache
view writes the stacked tensor) and ``tree_stack`` builds a stacked tree
from per-layer ones. The reference's ``REPRO_FULL_UNROLL`` switch (an
XLA cost-analysis device) has no counterpart: a loop is always unrolled.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leafwise over dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_at(tree: PyTree, i: int) -> PyTree:
    """Index ``i`` of every leaf's leading axis (views)."""
    return tree_map(lambda t: t[i], tree)


def tree_stack(trees: Sequence[PyTree]) -> PyTree:
    """Per-layer trees of one structure stacked on a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)

