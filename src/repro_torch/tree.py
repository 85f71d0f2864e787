"""Nested containers of tensors (the port's pytrees): dicts, NamedTuples,
tuples and lists, flattened in the order ``jax.tree_util.tree_flatten``
gives — dict keys sorted, NamedTuple fields and sequence items in order —
so a checkpoint's leaf list is the same in both packages."""

from __future__ import annotations


def tree_flatten(tree):
    """(leaves, treedef); everything that is not a container is a leaf."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return (type(t), None, tuple(walk(x) for x in t))
        if isinstance(t, (tuple, list)):
            return (type(t), None, tuple(walk(x) for x in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, kids)}
        if hasattr(kind, "_fields"):
            return kind(*(build(c) for c in kids))
        return kind(build(c) for c in kids)

    return build(treedef)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
