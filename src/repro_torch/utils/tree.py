"""Helpers over the port's parameter trees: nested dicts whose leaves are
tensors. Leaves are visited in sorted key order at every level, the order
``jax.tree_util`` flattens a dict in, so sums over a tree add the leaves
in the reference's order."""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(f: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``f`` over matching leaves of one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return f(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_count_params(tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_unflatten(like: Tree, leaves: list) -> Tree:
    """A tree shaped like ``like`` whose leaves, in leaf order, are
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
