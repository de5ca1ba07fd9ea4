"""Trees of tensors: nested dicts and lists, any other value a leaf (a
tuple too, as a leaf's per-dim axes are).  Leaves come in insertion
order, the order every flat list of the port's parameters, gradients and
optimizer state follows."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unflatten(struct, it):
    if isinstance(struct, dict):
        return {k: _unflatten(v, it) for k, v in struct.items()}
    if isinstance(struct, list):
        return [_unflatten(v, it) for v in struct]
    return next(it)


def tree_unflatten(struct, leaves):
    """``struct``'s structure holding ``leaves``, in ``tree_leaves``'s
    order."""
    return _unflatten(struct, iter(leaves))


def tree_map(fn, tree):
    """``fn`` on every leaf of ``tree``."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
