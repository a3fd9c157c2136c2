"""Parameter trees: nested dicts and lists with tensor leaves."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in a fixed order: dict keys sorted (as JAX orders them), then
    list order.  Two trees of one structure give aligned leaves whatever
    order their dicts were built in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
