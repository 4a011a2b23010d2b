"""Parameter and state trees in the reference's pytree order.

The reference's states are pytrees that ``jax.tree.flatten`` walks in a
fixed order: a dict's keys sorted, a tuple's (a NamedTuple's fields) in
order, None an empty subtree.  The port keeps the same trees of tensors,
so the same walk gives the same leaves in the same order: what the
optimizer maps over and what a checkpoint stores.  A parameter tree of
``lm/model.py`` also holds per-layer views into its stacked trees
(``"layers"`` and the like); they are not leaves of their own and are left
out of every walk, and :func:`unflatten` builds them again.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

from repro_torch.lm.model import VIEWS, with_views

#: keys of the per-layer views, which no walk visits
VIEW_KEYS = frozenset(VIEWS.values())


def _keys(tree: dict) -> list:
    return sorted(k for k in tree if k not in VIEW_KEYS)


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for k in _keys(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif t is not None:
            out.append(t)

    walk(tree)
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest``; the same structure, without views."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree if k not in VIEW_KEYS}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(ref, values) -> Any:
    """The structure of ``ref`` with its leaves taken in order from
    ``values`` (an iterable, e.g. :func:`leaves` of another tree); a dict
    that held per-layer views gets them again, into its new leaves."""
    it: Iterator = iter(values)

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in _keys(t)}
            out = {k: new[k] for k in t if k in new}
            return with_views(out) if any(k in VIEW_KEYS for k in t) \
                else out
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        try:
            return next(it)
        except StopIteration:
            raise ValueError("unflatten: fewer values than the tree has "
                             "leaves") from None

    out = build(ref)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the tree has leaves")
    return out
