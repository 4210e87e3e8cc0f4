"""Nested containers of tensors, the port's pytrees: dicts, lists, tuples
and NamedTuples (``AdamWState``), with None as an empty subtree.

They are walked in the order ``jax.tree_util`` walks the reference's:
dict keys sorted, list and tuple entries by index, NamedTuple fields in
field order.  ``flatten_with_names`` joins the keys of a leaf's path with
"/" as the reference's checkpoint manager does, so the two packages give
the same leaf names in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, values):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if _is_namedtuple(node):
        return type(node)(*values)
    return type(node)(values)


def flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """[(name, leaf)] in the reference's order, names like
    ``params/decoder/unrolled/0/mixer/a_log`` or ``opt/m/embed``."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for k, child in kids:
            walk(child, path + (str(k),))
    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [dict(_children(r)) for r in rest]
    return _rebuild(tree, [tree_map(fn, child, *(o[k] for o in others))
                           for k, child in kids])


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it: Iterator = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
