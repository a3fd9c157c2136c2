"""Error-map guided ray sampling state (counterpart of
stable_nerf_tpu/models/nerf/error_map.py).

The reference can importance-sample rays from a per-image 128×128 error
map (utils/graphics_utils.py:56-66 sampling; EMA update at
nerf/network.py:163-184), though its drivers never turn it on
(renderer.py:48 error_map=None).  ``data.rays.get_rays(...,
error_map=...)`` samples; this module holds the init and the update.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.device import resolve_device


def error_map_init(n_images: int, resolution: int = 128, *,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """[n_images, resolution²] uniform initial error on ``device`` (default
    cuda)."""
    return torch.ones((n_images, resolution * resolution), dtype=torch.float32,
                      device=resolve_device(device))


def update_error_map(error_map: torch.Tensor, index: torch.Tensor,
                     inds_coarse: torch.Tensor, error) -> torch.Tensor:
    """EMA of the sampled cells with fresh per-ray error (reference
    nerf/network.py:177-184): ema = 0.1·old + 0.9·error, written back at
    the coarse indices; returns a new map.

    error_map: [n_images, R²];  index: [B] image indices of the batch;
    inds_coarse: [B, N] (get_rays' error-map mode);  error: [B, N] or a
    scalar, per-ray error in [0, 1].
    """
    error = torch.as_tensor(error, dtype=torch.float32,
                            device=error_map.device).expand(inds_coarse.shape)
    index = torch.as_tensor(index, device=error_map.device).long()
    rows = error_map[index]                                        # [B, R²]
    old = torch.gather(rows, 1, inds_coarse)
    new_rows = rows.scatter(1, inds_coarse, 0.1 * old + 0.9 * error)
    out = error_map.clone()
    out[index] = new_rows
    return out
