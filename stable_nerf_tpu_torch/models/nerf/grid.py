"""Occupancy-grid state and maintenance (counterpart of
stable_nerf_tpu/models/nerf/grid.py; reference nerf/renderer.py:28-48
state, :174-234 mark_untrained_grid, :236-327 update_extra_state).

The grid lives in linear (x·H² + y·H + z) order as a bool tensor, as in
the JAX package.  The choice between the full and the partial sweep reads
the refresh counter on the host once per refresh (JAX branches on the
device with ``lax.cond``).  The random numbers of a refresh (jitter noise,
the partial sweep's cell draws) come from a ``torch.Generator`` or are
injected, so a test can feed the numbers JAX's key splits produce.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ...config import NeRFConfig
from ...utils.device import resolve_device
from ...utils.profiling import span


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


def reset_extra_state(cfg: NeRFConfig, *,
                      device: Optional[torch.device] = None) -> OccupancyGridState:
    """Zero all grid state, the −1 untrained marks included (reference
    renderer.py:60-68)."""
    return grid_init(cfg, device=device)


def _cell_coords(H: int, device) -> torch.Tensor:
    """[H³, 3] int32 cell coordinates in linear order."""
    r = torch.arange(H, dtype=torch.int32, device=device)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def _cascade_bounds(cfg: NeRFConfig, cas: int) -> Tuple[float, float]:
    bound = min(2 ** cas, cfg.bound)
    return bound, bound / cfg.grid_size


def mark_untrained_grid(state: OccupancyGridState, poses: torch.Tensor,
                        intrinsic: Sequence[float], cfg: NeRFConfig) -> OccupancyGridState:
    """Mark the cells outside every camera frustum as untrainable (−1).

    A cell is seen by a camera when its centre lies in front of it (z > 0)
    within the pinhole frustum widened by 2·half_grid_size.  One pose at a
    time, as JAX's scan, so memory stays one [H³, 3] block.

    poses: [B, 4, 4] cam2world on the grid's device; intrinsic (fx, fy,
    cx, cy)."""
    H = cfg.grid_size
    dev = state.density_grid.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    fx, fy, cx, cy = [float(v) for v in intrinsic]
    world = 2.0 * _cell_coords(H, dev).float() / (H - 1) - 1.0     # [H³, 3]

    counts = []
    for cas in range(cfg.cascade):
        bound, hgs = _cascade_bounds(cfg, cas)
        cw = world * (bound - hgs)
        count = torch.zeros(H ** 3, dtype=torch.int32, device=dev)
        for pose in poses:
            # world2cam: (x − t) @ R for the c2w rotation R
            cam = (cw - pose[:3, 3][None, :]) @ pose[:3, :3]
            mz = cam[:, 2] > 0
            mx = cam[:, 0].abs() < cx / fx * cam[:, 2] + hgs * 2
            my = cam[:, 1].abs() < cy / fy * cam[:, 2] + hgs * 2
            count += (mz & mx & my).to(torch.int32)
        counts.append(count)

    count = torch.stack(counts)                                     # [CAS, H³]
    grid = torch.where(count == 0, torch.full_like(state.density_grid, -1.0),
                       state.density_grid)
    return state._replace(density_grid=grid)


@torch.no_grad()
def update_extra_state(state: OccupancyGridState,
                       density_fn: Callable[[torch.Tensor], torch.Tensor],
                       cfg: NeRFConfig, *, generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
                       decay: float = 0.95, chunk: int = 2 ** 16) -> OccupancyGridState:
    """Epoch-cadence density-grid refresh (reference renderer.py:236-327),
    the span ``grid.refresh`` (``utils/profiling.py``).

    The first 16 refreshes sweep every cell of every cascade; later ones a
    quarter of the cells at random plus as many draws among the occupied
    cells.  Then the EMA ``max(decay·old, new)`` on cells valid in both
    grids, the mean density, and the occupancy at
    ``min(mean_density, density_thresh)``.

    density_fn: x [M, 3] in [-bound, bound] → sigma [M] (already scaled by
      density_scale); evaluated in chunks of ``chunk`` points, no grad.
    draws: optional injected numbers, each a sequence indexed by cascade:
      ``noise`` [M, 3] uniform in [-1, 1) (M = H³ in the full sweep, H³/2
      in the partial one), and for the partial sweep ``rand_idx`` [H³/4]
      int, ``u`` [H³/4] uniform in [0, 1), ``fallback_idx`` [H³/4] int
      (used while a cascade has no occupied cell).  Any that is missing is
      drawn from ``generator``.
    """
    with span("grid.refresh"):
        draws = draws or {}
        H, C = cfg.grid_size, cfg.cascade
        H3 = H ** 3
        dev = state.density_grid.device
        coords_all = _cell_coords(H, dev)

        def draw(name, cas, make):
            if name in draws:
                return torch.as_tensor(draws[name][cas], device=dev)
            if generator is None:
                raise ValueError(f"draw {name!r} was not given and no generator was")
            return make()

        def sweep_cascade(cas: int, cell_idx: Optional[torch.Tensor]) -> torch.Tensor:
            """Density at jittered cell centres of one cascade."""
            bound, hgs = _cascade_bounds(cfg, cas)
            coords = coords_all if cell_idx is None else coords_all[cell_idx]
            xyzs = (2.0 * coords.float() / (H - 1) - 1.0) * (bound - hgs)
            noise = draw("noise", cas, lambda: torch.rand(
                xyzs.shape, generator=generator, device=dev) * 2.0 - 1.0)
            xyzs = xyzs + noise * hgs
            return torch.cat([density_fn(x).float() for x in xyzs.split(chunk)])

        tmp = torch.full((C, H3), -1.0, dtype=torch.float32, device=dev)
        if int(state.iter_density) < 16:
            for cas in range(C):
                tmp[cas] = sweep_cascade(cas, None)
        else:
            N = H3 // 4
            for cas in range(C):
                rand_idx = draw("rand_idx", cas, lambda: torch.randint(
                    0, H3, (N,), generator=generator, device=dev))
                # uniform with replacement over the occupied cells by inverse
                # CDF; floor(u·total) in float32, as JAX computes it
                cnt = torch.cumsum((state.density_grid[cas] > 0).to(torch.int64), 0)
                total = cnt[-1]
                u = draw("u", cas, lambda: torch.rand(N, generator=generator, device=dev))
                r = torch.floor(u.float() * total.float()).to(torch.int64)
                occ_idx = torch.searchsorted(cnt, r, right=True).clamp(max=H3 - 1)
                # no occupied cell yet: uniform over all cells
                fallback = draw("fallback_idx", cas, lambda: torch.randint(
                    0, H3, (N,), generator=generator, device=dev))
                occ_idx = torch.where(total > 0, occ_idx, fallback.to(torch.int64))
                idx = torch.cat([rand_idx.to(torch.int64), occ_idx])
                tmp[cas, idx] = sweep_cascade(cas, idx)

        # EMA max-decay on cells valid in both grids (renderer.py:310-312)
        valid = (state.density_grid >= 0) & (tmp >= 0)
        grid = torch.where(valid, torch.maximum(state.density_grid * decay, tmp),
                           state.density_grid)
        mean_density = grid.clamp(min=0).mean()
        thresh = torch.clamp(mean_density, max=cfg.density_thresh)
        occ = (grid > thresh).reshape(C, H, H, H)
        return OccupancyGridState(density_grid=grid, occ=occ, mean_density=mean_density,
                                  iter_density=state.iter_density + 1)
