"""Nested ``dict``/``list``/``tuple`` parameter trees of tensors: the small
subset of ``jax.tree`` the port needs.  Leaves are visited in key order
of the first tree (dicts) or position (lists, tuples)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple tree, the port's
    ``jax.tree_util.tree_map_with_path``; a path is a tuple of dict keys and
    tuple positions.  Only plain lists and tuples are nodes: a
    ``torch.Size`` (a shape standing for a leaf) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(tree_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
