"""Trees of tensors in the order of ``jax.tree_util`` (what the optimizer,
the checkpoint, gradient compression and the train step walk).

A tree is nested dicts, lists, tuples and ``NamedTuple``s; every other
object is a leaf, except ``None``, which is no leaf (it stays in the
structure, as in JAX). Another subclass of ``tuple`` is a leaf, as JAX
takes one: a sharding spec ``distributed.shardings.P`` is a tuple, and a
spec tree's leaves are its specs. Dict keys are visited sorted,
sequences in order, so ``tree_leaves`` lists a tree's leaves as
``jax.tree_util.tree_leaves`` lists those of the same tree in JAX: a
checkpoint of either package restores into the other's template.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """The subtrees of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if type(tree) in (list, tuple) or _is_namedtuple(tree):
        return list(tree)
    return None


def _rebuild(node, children: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _iter_leaves(tree) -> Iterator[Any]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield tree
        return
    for kid in kids:
        yield from _iter_leaves(kid)


def tree_leaves(tree) -> List[Any]:
    """Every leaf, in ``jax.tree_util.tree_leaves`` order."""
    return list(_iter_leaves(tree))


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves``; raises ``ValueError`` if the counts differ."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            try:
                return next(it)
            except StopIteration:
                raise ValueError("too few leaves for the template") from None
        return _rebuild(node, [build(k) for k in kids])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("too many leaves for the template")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which must have ``tree``'s structure)."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])
