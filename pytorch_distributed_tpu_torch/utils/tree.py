"""Nested dict / list trees of tensors (the port's params layout: dicts,
with the blocks a list): leaves in a fixed order, and trees rebuilt from
leaves in that order."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree, path=()) -> Iterator[tuple[tuple, Any]]:
    """(key path, leaf) pairs, dicts in insertion order, lists by index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree):
    """The same structure with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def unflatten(like, flat: list):
    """A tree shaped like ``like`` whose leaves are ``flat``, in order."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_tree_with_path(fn: Callable, tree, path=()):
    """``map_tree`` with ``fn(path, leaf)`` (paths as ``leaves_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_tree_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def map_tree2(fn: Callable, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (``other``'s
    leaves may be tuples, such as sharding specs)."""
    if isinstance(tree, dict):
        return {k: map_tree2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)
