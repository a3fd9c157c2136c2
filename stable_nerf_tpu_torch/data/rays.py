"""Camera → ray generation (counterpart of stable_nerf_tpu/data/rays.py):
every pixel, or N sampled rays (uniform, patches, or weighted by an error
map), with the random draws from an explicit ``torch.Generator`` or
given."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def _sample_inds(B: int, H: int, W: int, N: int, generator, error_map, patch_size: int,
                 draws: Mapping[str, torch.Tensor], dev) -> Tuple[torch.Tensor, Dict]:
    """Pixel indices [B, N] of the sampled rays (graphics_utils.py:34-66),
    and the error-map mode's ``inds_coarse``."""
    def draw(name, make):
        if name in draws:
            return torch.as_tensor(draws[name], device=dev)
        if generator is None:
            raise ValueError(f"get_rays with N > 0 needs a generator or the draw {name!r}")
        return make()

    if patch_size > 1:
        # random top-left corners, then a dense patch grid
        num_patch = N // patch_size ** 2
        inds_x = draw("inds_x", lambda: torch.randint(0, H - patch_size, (num_patch,),
                                                      generator=generator, device=dev))
        inds_y = draw("inds_y", lambda: torch.randint(0, W - patch_size, (num_patch,),
                                                      generator=generator, device=dev))
        pi, pj = torch.meshgrid(torch.arange(patch_size, device=dev),
                                torch.arange(patch_size, device=dev), indexing="ij")
        rows = (inds_x[:, None] + pi.reshape(1, -1)).reshape(-1)
        cols = (inds_y[:, None] + pj.reshape(1, -1)).reshape(-1)
        inds = (rows * W + cols).long()
        return inds[None].expand(B, inds.shape[0]), {}
    if error_map is None:
        inds = draw("inds", lambda: torch.randint(0, H * W, (N,), generator=generator,
                                                  device=dev)).long()      # may repeat
        return inds[None].expand(B, N), {}
    # weighted sampling without replacement on the 128×128 error grid
    # (torch.multinomial(replacement=False) in the reference) by the
    # Gumbel-top-k trick, then a uniform offset inside the coarse cell
    logits = torch.log(torch.clamp(torch.as_tensor(error_map, dtype=torch.float32,
                                                   device=dev), min=1e-12))
    gumbel = draw("gumbel", lambda: -torch.log(-torch.log(
        torch.rand(logits.shape, generator=generator, device=dev).clamp(
            torch.finfo(torch.float32).tiny, 1.0))))
    inds_coarse = torch.topk(logits + gumbel, N, dim=-1).indices
    ux = draw("ux", lambda: torch.rand((B, N), generator=generator, device=dev))
    uy = draw("uy", lambda: torch.rand((B, N), generator=generator, device=dev))
    sx, sy = H / 128.0, W / 128.0
    ix = torch.clamp((torch.div(inds_coarse, 128, rounding_mode="floor").float() * sx
                      + ux * sx).to(torch.int32), max=H - 1)
    iy = torch.clamp(((inds_coarse % 128).float() * sy + uy * sy).to(torch.int32),
                     max=W - 1)
    return (ix * W + iy).long(), {"inds_coarse": inds_coarse}


def get_rays(poses: torch.Tensor, intrinsics: Sequence[float], H: int, W: int,
             N: int = -1, generator: Optional[torch.Generator] = None,
             error_map: Optional[torch.Tensor] = None, patch_size: int = 1,
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Rays of [B, 4, 4] cam2world poses (reference
    utils/graphics_utils.py:6-88): pixel centres at +0.5, directions
    normalized before rotation.

    N: -1 = every pixel; N > 0 = min(N, H·W) sampled rays: ``patch_size``
      > 1 takes N // patch_size² patches at random corners (``error_map``
      ignored); else with ``error_map`` [B, 128²] the Gumbel-top-k without
      replacement on the coarse grid, then a uniform offset in each cell;
      else N uniform pixels (repeats allowed), shared across the batch.
    draws: the random numbers, where given, instead of drawing them from
      ``generator``: ``inds_x``, ``inds_y`` [N // patch_size²] (patches),
      ``inds`` [N] (uniform), ``gumbel`` [B, 128²] and ``ux``, ``uy``
      [B, N] in [0, 1) (error map).

    Returns {'rays_o', 'rays_d': [B, N, 3], 'inds': [B, N]}, plus
    'inds_coarse' [B, N] in error-map mode.
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
    results: Dict[str, torch.Tensor] = {}
    if N > 0:
        inds, extra = _sample_inds(B, H, W, min(N, H * W), generator, error_map,
                                   patch_size, draws or {}, dev)
        results.update(extra)
        i = torch.gather(i, 1, inds)
        j = torch.gather(j, 1, inds)
    else:
        inds = torch.arange(H * W, device=dev)[None].expand(B, H * W)
    zs = torch.ones_like(i)
    directions = torch.stack([(i - cx) / fx * zs, (j - cy) / fy * zs, zs], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    rays_d = torch.einsum("bnk,bjk->bnj", directions, poses[:, :3, :3])
    rays_o = poses[:, None, :3, 3].expand(rays_d.shape)
    results.update(rays_o=rays_o, rays_d=rays_d, inds=inds)
    return results


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
