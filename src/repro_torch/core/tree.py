"""Nested containers of tensors (parameter, gradient and optimizer trees).

The port's counterpart of the ``jax.tree`` functions it needs: dicts,
NamedTuples, lists and tuples are nodes, ``None`` is an empty node, and
everything else is a leaf.  :func:`flatten` orders leaves as
``jax.tree.flatten`` does (dict keys sorted, NamedTuple fields and sequence
items in order), so a checkpoint's leaf ``i`` means the same array in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

__all__ = ["TreeDef", "flatten", "unflatten", "tree_map", "leaves"]


class TreeDef(NamedTuple):
    """A tree's structure: ``kind`` is "leaf", "none", "dict", "namedtuple",
    "list" or "tuple"; ``meta`` the sorted keys or the NamedTuple type."""

    kind: str
    meta: Any
    children: tuple

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(map(str, self.children))
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "namedtuple":
            return f"{self.meta.__name__}({inner})"
        return f"[{inner}]" if self.kind == "list" else f"({inner},)"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree: Any) -> tuple[list, TreeDef]:
    out: list = []

    def walk(t) -> TreeDef:
        if t is None:
            return TreeDef("none", None, ())
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return TreeDef("dict", keys, tuple(walk(t[k]) for k in keys))
        if _is_namedtuple(t):
            return TreeDef("namedtuple", type(t), tuple(map(walk, t)))
        if isinstance(t, (list, tuple)):
            return TreeDef(type(t).__name__, None, tuple(map(walk, t)))
        out.append(t)
        return TreeDef("leaf", None, ())

    return out, walk(tree)


def unflatten(treedef: TreeDef, leaves_: list) -> Any:
    it = iter(leaves_)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "namedtuple":
            return d.meta(*kids)
        return list(kids) if d.kind == "list" else tuple(kids)

    return build(treedef)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping ``tree``'s structure (and its dicts' key order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, t, *r) for t, *r in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]
