"""Minimal pytrees of tensors: the port's stand-in for ``jax.tree``.

A tree is a tensor (or numpy array), ``None``, or a dict, list, tuple or
NamedTuple of trees.  Leaves are visited in insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _flatten(tree, leaves: List[Any]) -> Callable:
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        subs = [(k, _flatten(v, leaves)) for k, v in tree.items()]
        return lambda it: {k: s(it) for k, s in subs}
    if isinstance(tree, (tuple, list)):
        subs = [_flatten(v, leaves) for v in tree]
        kind = type(tree)
        if hasattr(tree, "_fields"):                      # NamedTuple
            return lambda it: kind(*[s(it) for s in subs])
        return lambda it: kind(s(it) for s in subs)
    leaves.append(tree)
    return lambda it: next(it)


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """``(leaves, unflatten)`` with ``unflatten(leaves)`` rebuilding the tree."""
    leaves: List[Any] = []
    build = _flatten(tree, leaves)
    return leaves, lambda new: build(iter(new))


def tree_map(fn: Callable, tree):
    leaves, unflatten = tree_flatten(tree)
    return unflatten([fn(leaf) for leaf in leaves])
