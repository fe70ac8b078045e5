"""Nested parameter trees: dicts of tensors, with tuples, lists and ``None``
inside, as the model's parameters and the optimizers' states are.

The order of the leaves is ``jax.tree.flatten``'s, so that a tree of this
package and the reference's line up leaf for leaf (checkpoints, tests):
dict keys sorted, tuples and lists in order, and a ``None`` is no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree) -> List[Any]:
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


def unflatten(like, values) -> Any:
    """``like``'s structure with its leaves, in order, taken from ``values``."""
    it: Iterator = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more values than the tree has leaves")
    return out


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *same leaf of each of rest)`` at every leaf of ``tree``;
    each tree of ``rest`` has ``tree``'s structure, or it as a prefix (a
    subtree of ``rest`` at a leaf of ``tree`` is handed over whole)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
