"""Pytrees of tensors — nested dicts, lists and tuples — flattened in the
reference's leaf order (``jax.tree.flatten``): dict keys sorted, lists and
tuples in order, ``None`` an empty subtree. Parameters, Adam state and
checkpoints all use this order, so a checkpoint's ``leaf_<i>`` is the same
array in both packages.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, flat) -> Any:
    """A tree shaped like ``like`` whose leaves are taken in order from
    ``flat``."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` applied to every leaf of ``tree``."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def describe(tree) -> str:
    """The tree's structure in the reference's ``PyTreeDef`` notation."""
    def one(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {one(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(one(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(one(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({one(tree)})"
