"""Parameter trees: nested dicts and lists with tensor leaves."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


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
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``tree_leaves``' order, each path written as
    ``jax.tree_util.keystr`` writes it: ``['k']`` for a dict key, ``[i]``
    for a list index (e.g. ``['decoder']['up_blocks'][0]['conv1']['kernel']``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """Apply ``fn(path, leaf)`` to every leaf, the path as in
    ``tree_leaves_with_path``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def partition(tree: Any, mask: Any) -> Tuple[Any, Any]:
    """Split ``tree`` into (trainable, frozen) by a bool tree of the same
    structure; the complementary positions hold None (counterpart of
    stable_nerf_tpu/utils/pytree.py)."""
    trainable = tree_map(lambda x, m: x if m else None, tree, mask)
    frozen = tree_map(lambda x, m: None if m else x, tree, mask)
    return trainable, frozen


def combine(a: Any, b: Any) -> Any:
    """Merge two complementary partitions (None-filled) into one tree."""
    return tree_map(lambda x, y: x if x is not None else y, a, b)


def dealias(*trees: Any) -> Tuple[Any, ...]:
    """Clone every tensor leaf whose memory an earlier leaf across
    ``trees`` already uses, so that every leaf owns its memory: the
    optimizer updates leaves in place, and two leaves on one buffer would
    take each other's updates."""
    seen: set = set()

    def visit(x):
        if isinstance(x, torch.Tensor) and x.numel():
            key = (x.device, x.untyped_storage().data_ptr())
            if key in seen:
                return x.detach().clone().requires_grad_(x.requires_grad)
            seen.add(key)
        return x

    return tuple(tree_map(visit, t) for t in trees)
