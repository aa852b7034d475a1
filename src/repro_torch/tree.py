"""Pytree helpers for the port's nested parameter and state trees.

A tree is a dict, a NamedTuple (``TrainState``, ``AdamWState``), ``None``
(an empty subtree, as in JAX) or a leaf.  Dicts are walked in sorted key
order and NamedTuples in field order, the order ``jax.tree`` uses, so the
leaves, the "/"-joined paths and any sum over leaves come in the JAX
package's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs; a path joins dict keys and field names with
    "/" (``params/blocks/sub0/ln1``, ``opt/step``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        kids = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); dicts come back in sorted key
    order, the order of ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
            for f in tree._fields
        ))
    return fn(tree, *rest)


def unflatten(template: Any, flat: List[Any]) -> Any:
    """The tree of ``template``'s structure whose leaves are ``flat``, in
    the order of ``leaves(template)``."""
    it: Iterator[Any] = iter(flat)
    return tree_map(lambda _: next(it), template)
