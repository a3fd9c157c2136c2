"""Camera → ray generation (counterpart of stable_nerf_tpu/data/rays.py,
full-image mode; the random ray sampling modes are not ported yet)."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def get_rays(poses: torch.Tensor, intrinsics: Sequence[float], H: int,
             W: int) -> Dict[str, torch.Tensor]:
    """Rays of every pixel of [B, 4, 4] cam2world poses (reference
    utils/graphics_utils.py:6-88): pixel centres at +0.5, directions
    normalized before rotation.

    Returns {'rays_o', 'rays_d': [B, H·W, 3], 'inds': [B, H·W]}.
    """
    poses = poses.float()
    B = poses.shape[0]
    dev = poses.device
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    i = i.reshape(1, H * W).expand(B, H * W) + 0.5
    j = j.reshape(1, H * W).expand(B, H * W) + 0.5
    zs = torch.ones_like(i)
    directions = torch.stack([(i - cx) / fx * zs, (j - cy) / fy * zs, zs], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    rays_d = torch.einsum("bnk,bjk->bnj", directions, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    inds = torch.arange(H * W, device=dev)[None].expand(B, H * W)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


def rand_poses(generator: torch.Generator, size: int, radius: float = 1.0,
               theta_range: Tuple[float, float] = (math.pi / 3, 2 * math.pi / 3),
               phi_range: Tuple[float, float] = (0.0, 2 * math.pi)) -> torch.Tensor:
    """Random orbit-camera poses [size, 4, 4] with the reference's y-down up
    vector (graphics_utils.py:91-125), drawn from ``generator`` on its
    device."""
    dev = generator.device
    thetas = theta_range[0] + (theta_range[1] - theta_range[0]) * torch.rand(
        size, generator=generator, device=dev)
    phis = phi_range[0] + (phi_range[1] - phi_range[0]) * torch.rand(
        size, generator=generator, device=dev)
    centers = torch.stack([radius * torch.sin(thetas) * torch.sin(phis),
                           radius * torch.cos(thetas),
                           radius * torch.sin(thetas) * torch.cos(phis)], dim=-1)

    def normalize(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-10)

    forward = -normalize(centers)
    up = torch.tensor([0.0, -1.0, 0.0], device=dev).expand(forward.shape)
    right = normalize(torch.linalg.cross(forward, up))
    up = normalize(torch.linalg.cross(right, forward))
    poses = torch.eye(4, device=dev).repeat(size, 1, 1)
    poses[:, :3, :3] = torch.stack([right, up, forward], dim=-1)
    poses[:, :3, 3] = centers
    return poses


def nerf_matrix_to_ngp(pose, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """NeRF → ngp pose convention: axis cycle and flip, translation × scale
    (reference graphics_utils.py:129-137), on a [4, 4] (or [3, 4]) array."""
    pose = np.asarray(pose)
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
