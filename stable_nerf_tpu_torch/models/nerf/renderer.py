"""Volume renderer: march → NeRF eval → composite → background blend
(counterpart of stable_nerf_tpu/models/nerf/renderer.py, dense path).

  * image = composited + (1 − weights_sum)·bg_color
  * depth = clamp(depth − near, 0) / (far − near), 0 for missed rays
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...config import NeRFConfig
from ...ops.composite import composite_rays
from ...ops.marching import march_rays_lattice
from ...ops.ray_ops import near_far_from_aabb
from .grid import OccupancyGridState
from .network import nerf_apply


def _eval_samples(params, pos, dirs, cfg, compute_dtype, eval_chunk, stochastic):
    """NeRF-evaluate flat [M, 3] samples in ``eval_chunk`` pieces when M is
    a multiple of it, exactly where the reference's ``lax.map`` chunks: each
    chunk's hash encode is one backward scatter launch, and its index
    intermediates stay chunk-sized."""
    M = pos.shape[0]
    if M > eval_chunk and M % eval_chunk == 0:
        outs = [nerf_apply(params, p, d, cfg, compute_dtype, stochastic=stochastic)
                for p, d in zip(pos.split(eval_chunk), dirs.split(eval_chunk))]
        return torch.cat([s for s, _ in outs]), torch.cat([c for _, c in outs])
    return nerf_apply(params, pos, dirs, cfg, compute_dtype, stochastic=stochastic)


def render(params: Dict, grid_state: OccupancyGridState, rays_o, rays_d,
           cfg: NeRFConfig, *, bg_color=1.0, max_steps: int = 256,
           t_thresh: float = 1e-4, perturb: Optional[torch.Tensor] = None,
           n_samples: Optional[int] = None, compute_dtype=torch.float32,
           eval_chunk: int = 2 ** 17,
           sample_budget: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Render rays [..., 3] through the occupancy-grid NeRF.

    perturb: optional [N] uniforms in [0, 1) jittering each ray's t0 (the
      reference's perturb_key draw); training only, and it turns on the
      stochastic hash encode when the config asks for it.
    sample_budget: compaction is not ported yet; only a budget that does
      not bind (None, or >= the lattice size) runs.

    Returns {'image': [..., C], 'depth': [...], 'weights_sum': [...]}.
    """
    stochastic = cfg.hash_stochastic and perturb is not None
    prefix = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3).float()
    d = rays_d.reshape(-1, 3).float()
    N = o.shape[0]
    if sample_budget is not None and sample_budget < N * (n_samples or max_steps):
        raise NotImplementedError(
            "sample_budget compaction (ops/compaction.py) is not ported yet; "
            "see ROADMAP.md, port queue item 1")
    b = cfg.bound
    aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=o.device)
    nears, fars = near_far_from_aabb(o, d, aabb, cfg.min_near)
    pos, ts, dt, valid, t0 = march_rays_lattice(
        o, d, nears, fars, grid_state.occ, bound=cfg.bound, cascade=cfg.cascade,
        grid_size=cfg.grid_size, max_steps=max_steps, n_samples=n_samples,
        noise=perturb)
    K = ts.shape[1]
    M = N * K
    dirs = d[:, None, :].expand(N, K, 3)
    sig, rgb = _eval_samples(params, pos.reshape(M, 3), dirs.reshape(M, 3), cfg,
                             compute_dtype, eval_chunk, stochastic)
    sigmas = sig.reshape(N, K) * cfg.density_scale
    rgbs = rgb.reshape(N, K, cfg.channel_dim)
    weights_sum, depth, image = composite_rays(sigmas, rgbs, dt, ts, t0, valid,
                                               t_thresh)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=o.device)
    image = image + (1.0 - weights_sum)[:, None] * bg
    span = fars - nears
    depth = torch.where(span > 0,
                        torch.clamp(depth - nears, min=0) / torch.clamp(span, min=1e-10),
                        torch.zeros_like(depth))
    return {
        "image": image.reshape(*prefix, cfg.channel_dim),
        "depth": depth.reshape(*prefix),
        "weights_sum": weights_sum.reshape(*prefix),
    }
