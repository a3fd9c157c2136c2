"""Ray/AABB geometry (counterpart of stable_nerf_tpu/ops/ray_ops.py)."""

from __future__ import annotations

import math

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


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Ray ↔ sphere intersection → background-sphere coordinates [..., 2],
    (2·theta/π − 1, phi/π) in [-1, 1] (reference raymarching.cu:163-210,
    kernel_sph_from_ray).  Origins lie inside the sphere; y is up."""
    rays_o = rays_o.float()
    rays_d = rays_d.float()
    a = (rays_d * rays_d).sum(dim=-1)
    b = (rays_o * rays_d).sum(dim=-1)                 # B/2 of the quadratic
    c = (rays_o * rays_o).sum(dim=-1) - radius * radius
    t = (-b + torch.sqrt(b * b - a * c)) / a           # the larger, positive root
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, π)
    phi = torch.atan2(z, x)                            # [-π, π)
    inv_pi = 1.0 / math.pi
    return torch.stack([2 * theta * inv_pi - 1, phi * inv_pi], dim=-1)
