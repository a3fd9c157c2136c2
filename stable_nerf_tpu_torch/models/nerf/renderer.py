"""Volume renderer: march → NeRF eval → composite → background blend
(counterpart of stable_nerf_tpu/models/nerf/renderer.py).  One path serves
training and eval: eval is the same lattice with ``max_steps=512``, no
perturbation and, by default, a sample budget.

  * image = composited + (1 − weights_sum)·bg_color
  * depth = clamp(depth − near, 0) / (far − near), 0 for missed rays

Spans (``utils/profiling.py``): ``nerf.march`` (bounds, march, the budget's
compaction), ``nerf.mlp`` (the network over the samples) and
``nerf.composite``; counters ``render.samples`` (samples the network
evaluates: N·K dense, else the budget) and ``render.valid_samples`` (the
valid ones among them, a device count, taken only while spans are on).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...config import NeRFConfig
from ...ops.compaction import compact_plan, gather_compact, scatter_back
from ...ops.composite import composite_rays
from ...ops.marching import march_rays_lattice
from ...ops.ray_ops import near_far_from_aabb
from ...utils.profiling import count, span, spans_enabled
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
    sample_budget: if set and below the lattice size N·K, the network is
      evaluated on at most this many valid samples, packed step-major into
      a static buffer (ops/compaction.py); valid samples over the budget
      are dropped.  Padded slots carry position 0 and direction 0, their
      outputs are dropped by ``scatter_back`` and they get a zero
      cotangent.  None evaluates the dense lattice.

    Returns {'image': [..., C], 'depth': [...], 'weights_sum': [...]}.
    """
    stochastic = cfg.hash_stochastic and perturb is not None
    prefix = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3).float()
    d = rays_d.reshape(-1, 3).float()
    N = o.shape[0]
    b = cfg.bound
    with span("nerf.march"):
        aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=o.device)
        nears, fars = near_far_from_aabb(o, d, aabb, cfg.min_near)
        pos, ts, dt, valid, t0 = march_rays_lattice(
            o, d, nears, fars, grid_state.occ, bound=cfg.bound, cascade=cfg.cascade,
            grid_size=cfg.grid_size, max_steps=max_steps, n_samples=n_samples,
            noise=perturb)
        K = ts.shape[1]
        M = N * K
        budgeted = sample_budget is not None and sample_budget < M
        if budgeted:
            plan = compact_plan(valid, sample_budget)
            pos_c = gather_compact(plan, pos)
            # directions are constant along a ray: gather [budget] rows of the
            # [N, 3] ray directions (src // K is the ray)
            ray_of = torch.div(plan.src_idx, K, rounding_mode="floor").clamp(max=N - 1)
            dirs_c = d[ray_of.long()] * plan.slot_used[:, None].to(d.dtype)
            valid = plan.new_valid
    with span("nerf.mlp"):
        if budgeted:
            sig, rgb = _eval_samples(params, pos_c, dirs_c, cfg, compute_dtype,
                                     eval_chunk, stochastic)
            sig = scatter_back(plan, sig, M)
            rgb = scatter_back(plan, rgb, M)
        else:
            dirs = d[:, None, :].expand(N, K, 3)
            sig, rgb = _eval_samples(params, pos.reshape(M, 3), dirs.reshape(M, 3), cfg,
                                     compute_dtype, eval_chunk, stochastic)
    if spans_enabled():
        count("render.samples", sample_budget if budgeted else M)
        count("render.valid_samples", valid.sum())
    with span("nerf.composite"):
        sigmas = sig.reshape(N, K) * cfg.density_scale
        rgbs = rgb.reshape(N, K, cfg.channel_dim)
        weights_sum, depth, image = composite_rays(sigmas, rgbs, dt, ts, t0, valid,
                                                   t_thresh)
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=o.device)
        image = image + (1.0 - weights_sum)[:, None] * bg
        extent = fars - nears
        depth = torch.where(extent > 0,
                            torch.clamp(depth - nears, min=0) / torch.clamp(extent, min=1e-10),
                            torch.zeros_like(depth))
    return {
        "image": image.reshape(*prefix, cfg.channel_dim),
        "depth": depth.reshape(*prefix),
        "weights_sum": weights_sum.reshape(*prefix),
    }
