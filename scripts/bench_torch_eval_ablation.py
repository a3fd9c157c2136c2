#!/usr/bin/env python
"""The NeRF eval render split into cumulative stages on the card
(counterpart of scripts/bench_eval_ablation.py).

bench.py's ``nerf_eval_ms_per_image`` workload: one 64² latent view
(4,096 rays × 512 lattice steps) of the flagship NeRF at channel 4, the
grid marked from the view's pose (``mark_untrained_grid``) and refreshed
once, a budget of 64 samples a ray (64·4,096), bf16 compute, no gradient:

  march512        near/far + the 512-step masked-lattice march
  +compact        + ``compact_plan`` and the gathers of the packed
                  positions and directions
  +eval           + hash encode and MLPs on the packed samples
                  (``renderer._eval_samples``, chunks of 2^17)
  +scatter_back   + sigma and color scattered back to the [4,096, 512]
                  lattice
  full render     the benchmarked eval render (adds composite and the
                  background blend)

Times are the best of 3 blocks of 5 calls ending in a synchronize
(``torch_study.best_ms``): the JAX script's host readout exists for a
remote TPU runtime, the card is timed eagerly.

Usage: python scripts/bench_torch_eval_ablation.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torch_study import NERF_INTRINSICS, best_ms, device_line  # noqa: E402
from stable_nerf_tpu_torch.config import NeRFConfig  # noqa: E402
from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.grid import (grid_init, mark_untrained_grid,  # noqa: E402
                                                    update_extra_state)
from stable_nerf_tpu_torch.models.nerf.network import nerf_density, nerf_init  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.renderer import _eval_samples, render  # noqa: E402
from stable_nerf_tpu_torch.ops.compaction import (compact_plan, gather_compact,  # noqa: E402
                                                  scatter_back)
from stable_nerf_tpu_torch.ops.marching import march_rays_lattice  # noqa: E402
from stable_nerf_tpu_torch.ops.ray_ops import near_far_from_aabb  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402

MAX_STEPS = 512
BUDGET = 64 * 4096
EVAL_CHUNK = 2 ** 17


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def stage_march(cfg: NeRFConfig, occ, o, d):
    """near/far + the 512-step lattice march: (positions [N, K, 3], valid)."""
    b = cfg.bound
    aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=o.device)
    nears, fars = near_far_from_aabb(o, d, aabb, cfg.min_near)
    pos, _, _, valid, _ = march_rays_lattice(
        o, d, nears, fars, occ, bound=cfg.bound, cascade=cfg.cascade,
        grid_size=cfg.grid_size, max_steps=MAX_STEPS)
    return pos, valid


def stage_compact(cfg: NeRFConfig, occ, o, d, budget: int = BUDGET):
    """+ the packing: (packed positions, packed directions, plan)."""
    pos, valid = stage_march(cfg, occ, o, d)
    N, K = valid.shape
    plan = compact_plan(valid, budget)
    ray_of = torch.div(plan.src_idx, K, rounding_mode="floor").clamp(max=N - 1).long()
    dirs_c = d[ray_of] * plan.slot_used[:, None].to(d.dtype)
    return gather_compact(plan, pos), dirs_c, plan


def stage_eval(params, cfg: NeRFConfig, occ, o, d, budget: int = BUDGET):
    """+ the NeRF on the packed samples: (sigma [budget], color)."""
    pos_c, dirs_c, _ = stage_compact(cfg, occ, o, d, budget)
    return _eval_samples(params, pos_c, dirs_c, cfg, torch.bfloat16, EVAL_CHUNK, False)


def stage_scatter_back(params, cfg: NeRFConfig, occ, o, d, budget: int = BUDGET):
    """+ both scattered back to the lattice: (sigma [N, K], color [N, K, C])."""
    pos_c, dirs_c, plan = stage_compact(cfg, occ, o, d, budget)
    sig_c, rgb_c = _eval_samples(params, pos_c, dirs_c, cfg, torch.bfloat16, EVAL_CHUNK,
                                 False)
    N, K = plan.new_valid.shape
    return (scatter_back(plan, sig_c, N * K).reshape(N, K),
            scatter_back(plan, rgb_c, N * K).reshape(N, K, cfg.channel_dim))


def full_render(params, cfg: NeRFConfig, grid, o, d, budget: int = BUDGET):
    """The eval render: image, depth and weights_sum."""
    return render(params, grid, o, d, cfg, bg_color=1.0, max_steps=MAX_STEPS,
                  compute_dtype=torch.bfloat16, sample_budget=budget)


def setup(cfg: NeRFConfig, device, hw: int = 64, seed: int = 0):
    """Params, one pose's flat rays and its grid, marked from that pose and
    refreshed once, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = nerf_init(seed, cfg, device=device)
    poses = rand_poses(g, 1, radius=2.0)
    rays = get_rays(poses, NERF_INTRINSICS, hw, hw)
    with torch.no_grad():
        grid = mark_untrained_grid(grid_init(cfg, device=device), poses, NERF_INTRINSICS,
                                   cfg)
        grid = update_extra_state(grid, lambda x: nerf_density(params, x, cfg)["sigma"],
                                  cfg, generator=g)
    return params, grid, rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3)


def run(device, cfg: NeRFConfig = NeRFConfig(channel_dim=4), hw: int = 64,
        budget: int = BUDGET, n_iters: int = 5) -> dict:
    """{stage: ms} plus the grid's occupied fraction, at the given sizes
    (the JAX script's by default)."""
    params, grid, o, d = setup(cfg, device, hw)

    def ms(fn):
        return best_ms(fn, device, n_iters)

    with torch.no_grad():
        return {"occ_fraction": float(grid.occ.float().mean()),
                "march512": ms(lambda: stage_march(cfg, grid.occ, o, d)),
                "+compact": ms(lambda: stage_compact(cfg, grid.occ, o, d, budget)),
                "+eval": ms(lambda: stage_eval(params, cfg, grid.occ, o, d, budget)),
                "+scatter_back": ms(lambda: stage_scatter_back(params, cfg, grid.occ, o, d,
                                                               budget)),
                "full render": ms(lambda: full_render(params, cfg, grid, o, d, budget))}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    disable_tf32()
    print(device_line(dev))
    rows = run(dev)
    print(f"occ fraction: {rows.pop('occ_fraction'):.3f}")
    for name, v in rows.items():
        print(f"{name + ':':<17}{v:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
