"""Nested dicts and lists of tensors (the parameter trees): their leaves in
a fixed order, and maps over them.

The order is the trees' own: dict insertion order and list order, the
order in which ``convert.init_params`` and the checkpoint readers build
them, so that the leaves of two trees of one model line up.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def leaves(tree) -> List:
    """Every leaf (anything but a dict, list or tuple), depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """The key path of every leaf, in ``leaves``' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in paths(v, prefix + (str(i),))]
    return [prefix]


def map_tree(fn: Callable, tree, *others):
    """The tree of ``fn(leaf, *other leaves)``; the others have the same
    structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)


def unflatten(tree, flat: List):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in order."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def structure(tree):
    """The tree's structure and leaf shapes, comparable with ``==``."""
    return map_tree(lambda x: tuple(getattr(x, "shape", ())), tree)
