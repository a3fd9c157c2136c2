"""Weights made from the seed on the device, in a few large calls.

A template (``reference/sd.py``, ``reference/nerf.py``) gives each leaf's
shape and fill.  The leaves of one dtype are views of one flat buffer: one
``uniform_`` call draws the whole buffer from a generator seeded by
(seed, dtype), one ``_foreach_mul_`` scales each leaf to its bound, and the
zero and one fills are one ``_foreach`` call each.  The same seed gives the
same weights on the same device, so the program and the reference are each
handed the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def leaves_with_path(tree, prefix=()) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in leaves_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``: any
    whole number, however large, gives a 64-bit state."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2 ** 63 - 1))


def make(template, seed: int, device, dtype_of: Callable[[tuple], torch.dtype]) -> Dict:
    """The tensors of ``template`` (a tree of ``reference.sd.Spec``), leaf ``path`` in
    ``dtype_of(path)``, drawn from ``seed``."""
    specs = leaves_with_path(template)
    groups: Dict[torch.dtype, list] = {}
    for path, spec in specs:
        groups.setdefault(dtype_of(path), []).append((path, spec))
    out = {}
    for stream, dtype in enumerate(sorted(groups, key=str)):
        items = groups[dtype]
        sizes = [int(np.prod(s.shape)) for _, s in items]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        buf.uniform_(-1.0, 1.0, generator=generator(seed, stream, device))
        views = [v.view(s.shape) for v, (_, s) in zip(buf.split(sizes), items)]
        uni = [(v, s.scale) for v, (_, s) in zip(views, items) if s.fill == "uniform"]
        if uni:
            torch._foreach_mul_([v for v, _ in uni], [sc for _, sc in uni])
        zeros = [v for v, (_, s) in zip(views, items) if s.fill != "uniform"]
        if zeros:
            torch._foreach_zero_(zeros)
        ones = [v for v, (_, s) in zip(views, items) if s.fill == "ones"]
        if ones:
            torch._foreach_add_(ones, 1.0)
        out.update({path: v for v, (path, _) in zip(views, items)})
    return map_with_path(lambda path, _: out[path], template)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree

