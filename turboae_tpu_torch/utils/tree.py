"""Param trees: nested dicts and lists whose leaves are tensors."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in a fixed order: dicts in insertion order, lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A tree shaped like `tree` whose leaves are `leaves`, in tree_leaves order."""
    it: Iterator = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError('more leaves than the tree has')
    return out


def tree_map(fn: Callable, tree) -> Any:
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])
