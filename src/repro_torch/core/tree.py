"""Nested parameter trees (dicts and lists of tensors) in JAX's order.

The port keeps the reference's parameter pytrees as plain nested dicts
and lists, and flattens them as ``jax.tree`` does: dict keys sorted,
lists in order.  So a flat (k, P) basis made by the reference maps onto
the port's leaves one for one, and leaf paths ("segments/0/0/attn/wq")
name the same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's flatten order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += leaves_with_paths(sub, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, sub, *(r[i] for r in rest))
                for i, sub in enumerate(tree)]
    return fn(tree, *rest)


def map_with_paths(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` applied leaf by leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {key: map_with_paths(fn, sub, f"{prefix}{key}/")
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, sub, f"{prefix}{i}/")
                for i, sub in enumerate(tree)]
    return fn(prefix[:-1], tree)
