"""Minimal pytrees of tensors, flattened in JAX's leaf order.

JAX flattens a dict in sorted key order. The shuffle wire lays leaves out in
flattening order, and the leaf order fixes every leaf's counter range, so
the port must flatten exactly as JAX does to draw the same keystream.
Supported containers: dict, list, tuple; anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """Return (leaves, treedef); `tree_unflatten(treedef, leaves)` inverts it.
    `is_leaf(node)` True stops the walk at a container (e.g. a spec tuple)."""
    leaves: list = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return ("leaf", None, None)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        kind, keys, children = node
        if kind == "leaf":
            return next(it)
        values = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, values))
        return tuple(values) if kind == "tuple" else list(values)

    return build(treedef)


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over one or more trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
