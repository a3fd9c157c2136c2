"""Fixed-shape occupancy-grid ray marching (counterpart of
stable_nerf_tpu/ops/marching.py).

With ``dt_gamma == 0`` the reference's CUDA march keeps ``t`` on the
uniform lattice ``t0 + k·dt``, so marching is "evaluate every lattice point,
mask those in unoccupied voxels" — no compaction, no dynamic shapes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

SQRT3 = math.sqrt(3.0)


def mip_from_pos(pos: torch.Tensor, cascade: int) -> torch.Tensor:
    """Mip level from the frexp exponent of max|coord| (reference
    raymarching.cu:43-48), clamped to [0, cascade-1]; frexp(0) gives 0."""
    _, exp = torch.frexp(pos.abs().amax(dim=-1))
    return torch.clamp(exp, 0, cascade - 1).to(torch.int32)


def mip_from_dt(dt: torch.Tensor, grid_size: int, cascade: int) -> torch.Tensor:
    """Mip level from the step size (reference raymarching.cu:50-55)."""
    _, exp = torch.frexp(dt * grid_size * 0.5)
    return torch.clamp(exp, 0, cascade - 1).to(torch.int32)


def occupancy_lookup(occ_grid: torch.Tensor, pos: torch.Tensor, dt: torch.Tensor,
                     bound: float, cascade: int, grid_size: int) -> torch.Tensor:
    """Query the [cascade, H, H, H] bool grid (linear x, y, z order) at
    world positions [..., 3] already clamped to [-bound, bound].

    Voxel addressing of raymarching.cu:366-380: level = max(mip from pos,
    mip from dt); voxel = trunc(0.5·(x/mip_bound + 1)·H) clamped to H-1.
    """
    H = grid_size
    level = torch.maximum(mip_from_pos(pos, cascade),
                          mip_from_dt(dt, H, cascade))
    mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
    scaled = 0.5 * (pos / mip_bound[..., None] + 1.0) * H
    n = torch.clamp(scaled.to(torch.int32), 0, H - 1).long()
    idx = ((level.long() * H + n[..., 0]) * H + n[..., 1]) * H + n[..., 2]
    return occ_grid.reshape(-1)[idx]


def march_rays_lattice(rays_o, rays_d, nears, fars, occ_grid, *, bound: float,
                       cascade: int, grid_size: int, max_steps: int,
                       n_samples: Optional[int] = None,
                       noise: Optional[torch.Tensor] = None):
    """The masked sample lattice for a batch of rays.

    Args:
      rays_o, rays_d: [N, 3];  nears, fars: [N] from ``near_far_from_aabb``.
      occ_grid: [cascade, H, H, H] bool.
      max_steps: sets dt = 2·sqrt(3)/max_steps and caps the occupied
        samples per ray.
      n_samples: lattice length K (defaults to ``max_steps``).
      noise: optional [N] in [0, 1): t0 += dt·noise.

    Returns (xyzs [N, K, 3] clamped to the box, ts [N, K], dt (0-d float32
    tensor), valid [N, K] bool, t0 [N]).
    """
    K = n_samples if n_samples is not None else max_steps
    dev = rays_o.device
    dt = torch.tensor(2.0 * SQRT3 / max_steps, dtype=torch.float32, device=dev)
    t0 = nears if noise is None else nears + dt * noise
    ks = torch.arange(K, dtype=torch.float32, device=dev)
    ts = t0[:, None] + ks[None, :] * dt
    pos = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    pos = torch.clamp(pos, -bound, bound)
    in_range = ts < fars[:, None]
    valid = in_range & occupancy_lookup(occ_grid, pos, dt, bound, cascade,
                                        grid_size)
    if K > max_steps:   # num_steps cap (raymarching.cu:360)
        valid = valid & (torch.cumsum(valid.to(torch.int32), dim=-1) <= max_steps)
    return pos, ts, dt, valid, t0
