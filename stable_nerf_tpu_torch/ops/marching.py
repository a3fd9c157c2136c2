"""Fixed-shape occupancy-grid ray marching (counterpart of
stable_nerf_tpu/ops/marching.py).

With ``dt_gamma == 0`` the reference's CUDA march keeps ``t`` on the
uniform lattice ``t0 + k·dt``, so marching is "evaluate every lattice point,
mask those in unoccupied voxels" — no compaction, no dynamic shapes.
``march_rays_iterative``, the CUDA march step for step, is the oracle of
that equivalence and the only path for ``dt_gamma > 0``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.device import device_constant

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
    dt = device_constant(2.0 * SQRT3 / max_steps, dev)
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


def march_rays_iterative(rays_o, rays_d, nears, fars, occ_grid, *, bound: float,
                         cascade: int, grid_size: int, max_steps: int,
                         dt_gamma: float = 0.0, n_samples: Optional[int] = None,
                         noise: Optional[torch.Tensor] = None,
                         iter_max: Optional[int] = None):
    """The CUDA DDA march (kernel_march_rays_train, raymarching.cu:312-491)
    step for step, all rays at once: cone-angle stepping (``dt_gamma > 0``,
    raymarching.cu:366) and the analytic skip of empty voxels
    (raymarching.cu:390-399).  Slow but exact: the oracle of
    ``march_rays_lattice``, to which it is equivalent at dt_gamma == 0.

    Every iteration either writes a sample (at most ``max_steps``) or
    crosses a voxel boundary (about 3H a cascade), so ``iter_max`` defaults
    to max_steps + 4·H·cascade; the loop stops early once no ray is left.

    Returns xyzs [N, K, 3], ts [N, K] (sample distances), dts [N, K] (each
    sample's step, the CUDA deltas[:, 0]), delta_depth [N, K]
    (deltas[:, 1]), valid [N, K] bool, t0 [N].
    """
    K = n_samples if n_samples is not None else max_steps
    H = grid_size
    o, d = rays_o.float(), rays_d.float()
    N, dev = o.shape[0], o.device
    dt_min = device_constant(2.0 * SQRT3 / max_steps, dev)
    dt_max = device_constant(2.0 * SQRT3 * 2 ** (cascade - 1) / H, dev)
    occ_flat = occ_grid.reshape(-1)
    n_iter = iter_max if iter_max is not None else max_steps + 4 * H * cascade
    if noise is None:
        noise = torch.zeros(N, device=dev)

    def step_of(t):
        return torch.clamp(t * dt_gamma, dt_min, dt_max)

    t0 = nears + step_of(nears) * noise
    rd = 1.0 / d
    t, last_t = t0.clone(), t0.clone()
    step = torch.zeros(N, dtype=torch.int64, device=dev)
    xyzs = torch.zeros((N, K, 3), device=dev)
    ts = torch.zeros((N, K), device=dev)
    dts = torch.zeros((N, K), device=dev)
    dd = torch.zeros((N, K), device=dev)
    valid = torch.zeros((N, K), dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        active = (t < fars) & (step < max_steps)
        if not bool(active.any()):
            break
        pos = torch.clamp(o + t[:, None] * d, -bound, bound)
        dt = step_of(t)
        level = torch.maximum(mip_from_pos(pos, cascade), mip_from_dt(dt, H, cascade))
        mip_bound = torch.clamp(torch.exp2(level.float()), max=bound)
        n = torch.clamp((0.5 * (pos / mip_bound[:, None] + 1.0) * H).to(torch.int32),
                        0, H - 1)
        flat = ((level.long() * H + n[:, 0]) * H + n[:, 1]) * H + n[:, 2]
        occ = occ_flat[flat.long()]
        write, skip = active & occ, active & ~occ
        # an occupied voxel: write the sample at this step
        t_new = t + dt
        r = torch.nonzero(write).squeeze(1)
        s = torch.clamp(step[r], max=K - 1)
        xyzs[r, s] = pos[r]
        ts[r, s] = t[r]
        dts[r, s] = dt[r]
        dd[r, s] = (t_new - last_t)[r]
        valid[r, s] = step[r] < K
        # an empty one: step to the voxel's far boundary, at least once
        bounds = ((n.float() + 0.5 + 0.5 * torch.sign(d)) / H * 2.0 - 1.0) * mip_bound[:, None]
        tt = t + ((bounds - pos) * rd).amin(dim=-1).clamp(min=0.0)
        t_skip = t + step_of(t)
        while True:
            more = skip & (t_skip < tt)
            if not bool(more.any()):
                break
            t_skip = torch.where(more, t_skip + step_of(t_skip), t_skip)
        t = torch.where(write, t_new, torch.where(skip, t_skip, t))
        last_t = torch.where(write, t_new, last_t)
        step = step + write.long()
    return xyzs, ts, dts, dd, valid, t0
