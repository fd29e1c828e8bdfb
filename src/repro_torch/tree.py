"""Nested parameter trees: dicts and lists with tensor leaves.

The reference keeps parameters, gradients and optimizer state as JAX
pytrees; the port keeps the same nesting with plain dicts and lists and
walks it with these helpers.  Dict keys are visited in sorted order, as
``jax.tree_util`` flattens them.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_map", "tree_paths"]


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` with paths like ``layers/0/attn/wq/w``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure, visiting
    leaves in :func:`tree_paths` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
