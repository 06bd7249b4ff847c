"""Minimal pytrees of tensors, flattened in JAX's leaf order.

JAX flattens a dict in sorted key order. The shuffle wire lays leaves out in
flattening order, and the leaf order fixes every leaf's counter range, so
the port must flatten exactly as JAX does to draw the same keystream.
Supported containers: dict, list, tuple; anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable


# The walkers are module-level functions, not closures that call
# themselves: a nested recursive function refers to itself through its
# closure cell, a reference cycle that would keep the leaves (device
# tensors) alive until the garbage collector runs.


def _flatten(node, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return ("leaf", None, None)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_flatten(node[k], leaves, is_leaf) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_flatten(v, leaves, is_leaf) for v in node])
    leaves.append(node)
    return ("leaf", None, None)


def tree_flatten(tree, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """Return (leaves, treedef); `tree_unflatten(treedef, leaves)` inverts it.
    `is_leaf(node)` True stops the walk at a container (e.g. a spec tuple)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, is_leaf)


def _build(node, it):
    kind, keys, children = node
    if kind == "leaf":
        return next(it)
    values = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, values))
    return tuple(values) if kind == "tuple" else list(values)


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def _paths(node, path: str, paths: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], f"{path}[{k!r}]", paths)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _paths(v, f"{path}[{i}]", paths)
    else:
        paths.append(path)


def tree_paths(tree) -> list[str]:
    """Each leaf's path in flattening order, as `jax.tree_util.keystr` writes
    it: `['key']` for a dict entry, `[i]` for a list or tuple item."""
    paths: list[str] = []
    _paths(tree, "", paths)
    return paths


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over one or more trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
