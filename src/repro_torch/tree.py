"""Parameter trees: nested dicts / lists / tuples of tensors.

``repro`` walks its parameters with ``jax.tree_util``, which visits dict
entries in sorted key order, list and tuple entries in order, and treats
``None`` as an empty subtree.  The wire-bit ledger is a float32 sum over
leaves in that order, so the port flattens the same way (PyTorch's own
pytree helpers keep dict insertion order instead).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


class TreeSpec:
    """The structure of a flattened tree (what ``tree_unflatten`` needs)."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys=None, children=()):
        self.kind = kind          # "leaf" | "none" | "dict" | "list" | "tuple"
        self.keys = keys
        self.children = tuple(children)


_LEAF = TreeSpec("leaf")


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(leaves, spec) in ``jax.tree_util`` order."""
    leaves: list = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return _LEAF
        if node is None:
            return TreeSpec("none")
        if isinstance(node, dict):
            keys = sorted(node)
            return TreeSpec("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return TreeSpec(kind, None, [walk(c) for c in node])
        leaves.append(node)
        return _LEAF

    spec = walk(tree)
    return leaves, spec


def tree_unflatten(spec: TreeSpec, leaves):
    it = iter(leaves)

    def build(s: TreeSpec):
        if s.kind == "leaf":
            return next(it)
        if s.kind == "none":
            return None
        kids = [build(c) for c in s.children]
        if s.kind == "dict":
            return dict(zip(s.keys, kids))
        return kids if s.kind == "list" else tuple(kids)

    return build(spec)


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` for a scalar ``fn(params, *args)``: returns
    ``(value, grads)`` with ``grads`` in ``params``' structure.  The
    caller's tensors are not modified (leaves are detached views of
    the graph inputs); a leaf the value does not use gets zeros."""

    def wrapped(params, *args):
        leaves, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            value = fn(tree_unflatten(spec, leaves), *args)
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
        return value.detach(), tree_unflatten(spec, list(grads))

    return wrapped
