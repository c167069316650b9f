"""Nested-dict parameter trees: leaves in ``jax.tree_util``'s order.

The port's parameters, moments and checkpoints are nested dicts (with
lists or tuples where a caller uses them) of tensors.  ``dict_leaves`` /
``map_dict`` walk dicts only, so trees whose leaves are tuples (logical
axes, sharding specs) keep them whole.  ``jax.tree_util``
flattens a dict in *sorted* key order whatever its insertion order, and
the reference's global gradient norm and checkpoint manifests follow that
order, so the port flattens the same way.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def tree_leaves_with_paths(tree: Any,
                           path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs: dict keys sorted, lists and tuples by index;
    ``None`` is an empty subtree, as in ``jax.tree_util``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_paths(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_paths(v, path + (i,))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flattening order,
    by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-structured ``rest``."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees differ in structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def dict_leaves(tree: Any) -> list:
    """Leaves of a nested-dict tree in sorted-key order (``tree_leaves``'
    order for the port's parameter trees), tuples kept whole."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in dict_leaves(tree[k])]
    return [tree]


def map_dict(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a nested-dict tree (tuples kept whole) and
    the same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: map_dict(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
