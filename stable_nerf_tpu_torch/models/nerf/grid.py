"""Occupancy-grid state (counterpart of stable_nerf_tpu/models/nerf/grid.py;
grid maintenance is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...config import NeRFConfig
from ...utils.device import resolve_device


class OccupancyGridState(NamedTuple):
    density_grid: torch.Tensor   # [CAS, H³] f32; -1 marks untrainable cells
    occ: torch.Tensor            # [CAS, H, H, H] bool, linear (x, y, z) order
    mean_density: torch.Tensor   # f32 scalar
    iter_density: torch.Tensor   # int32 scalar


def grid_init(cfg: NeRFConfig, *,
              device: Optional[torch.device] = None) -> OccupancyGridState:
    dev = resolve_device(device)
    H, C = cfg.grid_size, cfg.cascade
    return OccupancyGridState(
        density_grid=torch.zeros((C, H ** 3), dtype=torch.float32, device=dev),
        occ=torch.zeros((C, H, H, H), dtype=torch.bool, device=dev),
        mean_density=torch.zeros((), dtype=torch.float32, device=dev),
        iter_density=torch.zeros((), dtype=torch.int32, device=dev),
    )
