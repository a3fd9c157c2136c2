"""Static-budget sample compaction (counterpart of
stable_nerf_tpu/ops/compaction.py).

The renderer keeps the fixed [N, K] lattice for compositing but evaluates
the NeRF network only on the valid samples, packed front-first into a
``budget``-sized buffer by a cumsum partition.  Valid samples beyond the
budget are dropped (their mask is cleared), deterministically.

Gather and scatter are index ops, so gradients flow from the composited
loss back through ``scatter_back`` → network → ``gather_compact`` into the
hash table.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Compaction(NamedTuple):
    src_idx: torch.Tensor     # [budget] int32 flat source index, == NK on unused slots
    slot_used: torch.Tensor   # [budget] bool
    new_valid: torch.Tensor   # [N, K] valid mask minus over-budget drops
    n_valid: torch.Tensor     # 0-d int32: number of used slots


def compact_plan(valid: torch.Tensor, budget: int) -> Compaction:
    """The pack/unpack plan of a [N, K] validity mask.

    Packing is step-major: slots fill in (step, ray) order, so every ray's
    sample k packs before any ray's sample k+1, and an over-budget drop
    takes the far tail of the longest rays, never whole rays."""
    N, K = valid.shape
    NK = N * K
    dev = valid.device
    flat = valid.reshape(-1)
    cnt_t = torch.cumsum(valid.T.reshape(-1), dim=0, dtype=torch.int32)  # (k, n) order
    rank = (cnt_t - 1).reshape(K, N).T.reshape(-1)                       # back to (n, k)
    # invalid and over-budget samples all write the trash slot ``budget``;
    # the kept slots have one writer each, so they are deterministic
    dest = torch.where(flat, rank.clamp(max=budget), budget).long()
    src = torch.full((budget + 1,), NK, dtype=torch.int32, device=dev)
    src.scatter_(0, dest, torch.arange(NK, dtype=torch.int32, device=dev))
    n_valid = cnt_t[-1].clamp(max=budget)
    slot_used = torch.arange(budget, dtype=torch.int32, device=dev) < n_valid
    new_valid = (flat & (rank < budget)).reshape(N, K)
    return Compaction(src[:budget], slot_used, new_valid, n_valid)


def gather_compact(plan: Compaction, x: torch.Tensor) -> torch.Tensor:
    """Pack x [N, K, ...] (or [NK, ...]) into [budget, ...]; unused slots 0."""
    flat = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])) if x.dim() >= 2 else x
    safe = plan.src_idx.clamp(max=flat.shape[0] - 1).long()
    out = flat[safe]
    mask = plan.slot_used.reshape((-1,) + (1,) * (out.dim() - 1))
    return out * mask.to(out.dtype)


def scatter_back(plan: Compaction, values: torch.Tensor, nk: int) -> torch.Tensor:
    """Unpack [budget, ...] back to flat [NK, ...]; dropped samples get 0.
    Unused slots land in a trash row ``nk`` that is cut off."""
    idx = torch.where(plan.slot_used, plan.src_idx, nk).long()
    out = torch.zeros((nk + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_copy(0, idx, values)[:nk]


def suggest_sample_budget(occ_fraction: float, n_rays: int, max_steps: int, *,
                          headroom: float = 1.5,
                          min_budget: int = 2 ** 16) -> Optional[int]:
    """Host-side adaptive budget from the grid's occupied fraction: the
    expected valid count × ``headroom``, rounded up to a power of two and
    floored at ``min_budget``.  None (render dense) when the estimate
    reaches the full lattice."""
    dense = n_rays * max_steps
    expect = occ_fraction * headroom * dense
    if expect >= dense:
        return None
    budget = max(int(min_budget), 1 << int(math.ceil(math.log2(max(expect, 1.0)))))
    return None if budget >= dense else budget
