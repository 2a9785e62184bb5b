"""Stacked-layer trees: what the reference's ``lax.scan`` walks, and the
pytree helpers the rest of the LM substrate shares.

Layer parameters (and decode caches) are nested dicts of tensors stacked
on a leading layer axis, as in the reference. The port walks that axis
with a Python loop (``models.model``): ``tree_at`` takes one layer's
views out of a stacked tree (no copy, so an in-place update of a cache
view writes the stacked tensor), ``tree_unstack`` takes all of them at
once (``unbind``: the gradients of the views come back as one stacked
tensor) and ``tree_stack`` builds a stacked tree from per-layer ones.
The reference's ``REPRO_FULL_UNROLL`` switch (an XLA cost-analysis
device) has no counterpart: a loop is always unrolled.

``tree_leaves`` and ``tree_leaves_with_path`` flatten in JAX's order
(dict keys sorted, list, tuple and ``NamedTuple`` items in order), so a
flat list of leaves (a checkpoint's arrays, a global norm's sum) is the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

PyTree = Any


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leafwise over dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: PyTree, prefix: str = ""
                          ) -> List[Tuple[str, Any]]:
    """(path, leaf) in JAX's flattening order; paths as the reference's
    checkpoint manifest names them: a dict key or a sequence index as
    itself, a ``NamedTuple`` field as ``.name``, joined by ``/``."""
    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_leaves_with_path(tree[k], join(str(k)))]
    if _is_namedtuple(tree):
        return [item for name, v in zip(tree._fields, tree)
                for item in tree_leaves_with_path(v, join(f".{name}"))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_leaves_with_path(v, join(str(i)))]
    return [(prefix, tree)]


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves in JAX's flattening order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like: PyTree, leaves: Sequence[Any]) -> PyTree:
    """A tree of ``like``'s structure holding ``leaves`` (in JAX's order,
    as ``tree_leaves(like)`` gives them)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_at(tree: PyTree, i: int) -> PyTree:
    """Index ``i`` of every leaf's leading axis (views)."""
    return tree_map(lambda t: t[i], tree)


def tree_unstack(tree: PyTree) -> List[PyTree]:
    """Every index of a stacked dict tree's leading axis at once
    (``unbind`` views), one tree per layer."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(tree)[0])

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    return [pick(parts, i) for i in range(n)]


def tree_stack(trees: Sequence[PyTree]) -> PyTree:
    """Per-layer trees of one structure stacked on a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)
