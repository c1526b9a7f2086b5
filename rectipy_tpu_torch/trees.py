"""Trees of dicts, tuples and lists, walked in the JAX package's order.

``jax.tree_util`` flattens dicts by sorted key, tuples and lists by
index, and treats ``None`` as an empty subtree; the checkpoints' keys
(``"params/nodes/<label>/<key>"``), a serving bundle's leaf order and
``lyapunov_direct``'s perturbation draws follow that order here.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Tuple

__all__ = ["items", "leaves", "rebuild", "fill"]


def items(tree, path: tuple = ()) -> Iterator[Tuple[tuple, object]]:
    """``(path, leaf)`` pairs: dict keys sorted, tuple and list items by
    index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], path + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from items(sub, path + (i,))
    elif tree is not None:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def rebuild(tree, fn: Callable, path: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, called in
    :func:`items`' order; dicts keep their key order."""
    if isinstance(tree, dict):
        done = {key: rebuild(tree[key], fn, path + (key,)) for key in sorted(tree)}
        return {key: done[key] for key in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(sub, fn, path + (i,)) for i, sub in enumerate(tree))
    return None if tree is None else fn(path, tree)


def fill(tree, values: Iterable):
    """``tree`` with its leaves replaced, in :func:`items`' order, by
    ``values``."""
    it = iter(values)
    return rebuild(tree, lambda path, leaf: next(it))
