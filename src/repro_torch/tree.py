"""Nested containers of tensors (the port's pytrees): dicts, NamedTuples,
tuples and lists, flattened in the order ``jax.tree_util.tree_flatten``
gives — dict keys sorted, NamedTuple fields and sequence items in order —
so a checkpoint's leaf list is the same in both packages."""

from __future__ import annotations


def _flatten(t, leaves):
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, tuple(keys), tuple(_flatten(t[k], leaves)
                                         for k in keys))
    if isinstance(t, (tuple, list)):                  # NamedTuples too
        return (type(t), None, tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return None


def tree_flatten(tree):
    """(leaves, treedef); everything that is not a container is a leaf.
    Module-level recursion, not a nested function that calls itself: such
    a closure is a reference cycle, and it would keep ``leaves`` (whole
    gradient trees) alive until the garbage collector ran."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, kids = d
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    if hasattr(kind, "_fields"):
        return kind(*(_build(c, it) for c in kids))
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
