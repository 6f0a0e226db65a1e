"""Helpers over the port's parameter trees: nested dicts (and, in the
recurrent families' trees, lists of layer trees and None) whose leaves are
tensors. Leaves are visited in sorted key order at every level and lists in
index order; a None holds no leaf: the order ``jax.tree_util`` flattens such
a tree in, so sums over a tree add the leaves in the reference's order. A
list of tensors is one leaf (the aggregators' per-cloud tensors of a leaf,
``core/aggregation.py``)."""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def _is_list_node(tree) -> bool:
    return isinstance(tree, list) and not (tree and isinstance(tree[0], torch.Tensor))


def tree_map(f: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``f`` over matching leaves of one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_list_node(tree):
        return [tree_map(f, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    if tree is None:
        return None
    return f(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if _is_list_node(tree):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_count_params(tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_unflatten(like: Tree, leaves: list) -> Tree:
    """A tree shaped like ``like`` whose leaves, in leaf order, are
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_bytes(tree: Tree) -> int:
    """Bytes of a tree's tensor leaves (real or meta): elements × element
    size."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024.0 or unit == "PB":
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PB"


def fmt_flops(n: float) -> str:
    for unit in ("FLOP", "KFLOP", "MFLOP", "GFLOP", "TFLOP", "PFLOP"):
        if abs(n) < 1000.0 or unit == "PFLOP":
            return f"{n:.2f} {unit}"
        n /= 1000.0
    return f"{n:.2f} PFLOP"
