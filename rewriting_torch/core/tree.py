"""Params trees: nested dicts (and, for the segmenters' block stacks,
lists) with a tensor at every leaf.

The port's one walker of such trees; the JAX package uses
``jax.tree_util`` for the same.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple


def tree_map(fn: Callable, tree):
    """The tree with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted name, leaf) for every leaf, depth first in key order; a
    list's items are named by their index."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, (dict, list, tuple)):
            yield from leaves(val, name)
        else:
            yield name, val
