"""Ray/AABB geometry (counterpart of stable_nerf_tpu/ops/ray_ops.py)."""

from __future__ import annotations

import torch

FLT_MAX = torch.finfo(torch.float32).max


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.2):
    """Slab-test ray/AABB intersection (reference raymarching.cu:92-157).

    Args:
      rays_o, rays_d: [..., 3].
      aabb: [6] (xmin, ymin, zmin, xmax, ymax, zmax).

    Returns (nears, fars), each [...] float32; rays that miss the box get
    near == far == FLT_MAX, and near is clamped to ``min_near``.
    """
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    rdir = 1.0 / rays_d                       # inf where d == 0, as in CUDA
    lo = (aabb[:3] - rays_o) * rdir
    hi = (aabb[3:] - rays_o) * rdir
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    return torch.where(miss, FLT_MAX, near), torch.where(miss, FLT_MAX, far)
