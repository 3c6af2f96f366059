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


def _flatten(node, is_leaf, leaves: list) -> TreeSpec:
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return _LEAF
    if node is None:
        return TreeSpec("none")
    if isinstance(node, dict):
        keys = sorted(node)
        return TreeSpec("dict", keys,
                        [_flatten(node[k], is_leaf, leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        # a NamedTuple's field names name its paths (``.field``, as
        # jax.tree_util names them)
        return TreeSpec(kind, getattr(node, "_fields", None),
                        [_flatten(c, is_leaf, leaves) for c in node])
    leaves.append(node)
    return _LEAF


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(leaves, spec) in ``jax.tree_util`` order.  The walks here are
    module-level functions, not nested closures: a recursive closure is a
    reference cycle that would keep every leaf it saw (a whole dense
    parameter tree) alive until the garbage collector runs."""
    leaves: list = []
    spec = _flatten(tree, is_leaf, leaves)
    return leaves, spec


def _paths(s: TreeSpec, prefix: tuple, out: list) -> None:
    if s.kind == "leaf":
        out.append(prefix)
    elif s.kind == "dict":
        for k, c in zip(s.keys, s.children):
            _paths(c, prefix + (k,), out)
    elif s.kind in ("list", "tuple"):
        for i, c in enumerate(s.children):
            _paths(c, prefix + (i if s.keys is None else "." + s.keys[i],),
                   out)


def tree_flatten_with_path(tree, is_leaf=None):
    """([(path, leaf)], spec): each leaf with its key path (dict keys,
    list / tuple indices and ``.field`` for a NamedTuple's fields, root
    first), in ``tree_flatten`` order."""
    leaves, spec = tree_flatten(tree, is_leaf)
    paths: list = []
    _paths(spec, (), paths)
    return list(zip(paths, leaves)), spec


def _build(s: TreeSpec, it):
    if s.kind == "leaf":
        return next(it)
    if s.kind == "none":
        return None
    kids = [_build(c, it) for c in s.children]
    if s.kind == "dict":
        return dict(zip(s.keys, kids))
    return kids if s.kind == "list" else tuple(kids)


def tree_unflatten(spec: TreeSpec, leaves):
    return _build(spec, iter(leaves))


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
