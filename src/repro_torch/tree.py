"""Nested dict/tuple/list trees: the port's stand-in for ``jax.tree_util``.

Parameter and cache trees are plain nested containers whose leaves are tensors
(or declarations such as ``ParamDef``/``TensorDef``). A tuple whose class sets
``tree_leaf`` (``parallel.sharding.PartitionSpec``) is a leaf, as JAX's
``PartitionSpec`` is a leaf of its spec trees."""
from __future__ import annotations

from typing import Any, Callable, List


def _seq(t: Any) -> bool:
    """A tuple or list node of a tree (not a tuple that is a leaf)."""
    return isinstance(t, (tuple, list)) and not getattr(t, "tree_leaf", False)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and any trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _seq(tree):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if _seq(tree):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_flatten_sorted(tree: Any, prefix: tuple = ()) -> List[tuple]:
    """[(path, leaf)] in ``jax.tree_util``'s flatten order: dict keys sorted,
    tuples and lists by index. ``path`` is the tuple of keys and indices. The
    optimizer and the checkpoint format iterate leaves in this order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten_sorted(tree[k], prefix + (k,))]
    if _seq(tree):
        return [x for i, t in enumerate(tree) for x in tree_flatten_sorted(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten_sorted(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves, in ``tree_flatten_sorted``
    order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep like's own key order
        if _seq(t):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
