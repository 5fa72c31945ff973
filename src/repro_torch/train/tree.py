"""Pytrees of the port: nested dicts, lists, tuples and NamedTuples of
tensors, walked as ``jax.tree_util`` walks the reference's (dict keys
in sorted order, NamedTuple fields in order, ``None`` an empty
subtree), so that leaf order and leaf paths are the reference's."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in the reference's order; a path is the dict keys,
    field names and list indices from the root, as strings."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    if tree is None:
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], prefix + (str(key),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            out += leaves_with_paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out += leaves_with_paths(sub, prefix + (str(i),))
    else:
        out.append((prefix, tree))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values: Iterator[Any]):
    """A tree shaped as ``like`` whose leaves are taken in order from
    ``values``."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {key: unflatten(like[key], values) for key in sorted(like)}
        return {key: new[key] for key in like}         # the caller's order
    if _is_namedtuple(like):
        return type(like)(*(unflatten(getattr(like, n), values)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(sub, values) for sub in like)
    return next(values)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, iter([fn(*xs) for xs in zip(*flat)]))
