"""Pytrees of the port: nested dicts, lists, tuples and NamedTuples of
tensors, walked as ``jax.tree_util`` walks the reference's (dict keys
in sorted order, NamedTuple fields in order, ``None`` an empty
subtree), so that leaf order and leaf paths are the reference's.

A tensor that sits at several places of one tree (tied: a period's MoE
layers sharing one expert set, ``init_params(share_experts=True)``) is
one leaf, at its first path, and :func:`unflatten` puts one value at
every place it sat: a gradient sums over its uses, an optimizer moves
it once, a checkpoint holds it once. The reference's trees tie
nothing, so their leaves are unchanged."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Set, \
    Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: Tuple[str, ...] = (),
                      _seen: Optional[Set[int]] = None
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in the reference's order; a path is the dict keys,
    field names and list indices from the root, as strings. A tied
    tensor is listed once, at its first path."""
    seen = set() if _seen is None else _seen
    out: List[Tuple[Tuple[str, ...], Any]] = []
    if tree is None:
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], prefix + (str(key),), seen)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            out += leaves_with_paths(getattr(tree, name), prefix + (name,),
                                     seen)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out += leaves_with_paths(sub, prefix + (str(i),), seen)
    elif not isinstance(tree, torch.Tensor) or id(tree) not in seen:
        if isinstance(tree, torch.Tensor):
            seen.add(id(tree))
        out.append((prefix, tree))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values: Iterator[Any],
              _tied: Optional[Dict[int, Any]] = None):
    """A tree shaped as ``like`` whose leaves are taken in order from
    ``values`` (one for each of :func:`leaves`: a tensor tied in
    ``like`` takes one value at every place it sits)."""
    tied = {} if _tied is None else _tied
    if like is None:
        return None
    if isinstance(like, dict):
        new = {key: unflatten(like[key], values, tied)
               for key in sorted(like)}
        return {key: new[key] for key in like}         # the caller's order
    if _is_namedtuple(like):
        return type(like)(*(unflatten(getattr(like, n), values, tied)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(sub, values, tied) for sub in like)
    if not isinstance(like, torch.Tensor):
        return next(values)
    if id(like) not in tied:
        tied[id(like)] = next(values)
    return tied[id(like)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, iter([fn(*xs) for xs in zip(*flat)]))
