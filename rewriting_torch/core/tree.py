"""Params trees: nested dicts with a tensor at every leaf.

The port's one walker of such trees; the JAX package uses
``jax.tree_util`` for the same.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple


def tree_map(fn: Callable, tree):
    """The tree with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted name, leaf) for every leaf, depth first in key order."""
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            yield from leaves(val, name)
        else:
            yield name, val
