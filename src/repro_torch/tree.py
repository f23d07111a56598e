"""Trees of tensors: the nested dicts and lists that hold the port's params,
optimizer state and train state (the JAX package's pytrees)."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves in order: dict values in their order, list items by index."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure, dict entries matched by key, so their
    orders may differ); the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
