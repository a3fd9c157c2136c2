#!/usr/bin/env python
"""The NeRF train render split into cumulative stages on the card
(counterpart of scripts/bench_step_ablation.py).

bench.py's ``nerf_train_rays_per_sec`` workload (the flagship NeRF
at channel 4, 2 poses × 64² = 8,192 rays, 256 march steps, the 128³ grid
all occupied, a sample budget of 2^18, bf16 compute), cut into stages so
that the next target is read from data:

  march            near/far + the masked-lattice march (occupancy lookup)
  march+compact    + ``compact_plan`` / ``gather_compact`` (budget packing)
  +mlps (no hash)  + the sigma and color MLPs fed by a hash-free stand-in
                   encode (the compacted positions tiled to the encoder's
                   32 features)
  full fwd         the real forward with the hash encode and composite,
                   the loss |image − 0.5|, exact and stochastic encode
  full fwd+bwd     the benchmarked step: the same with the gradient of
                   every NeRF param (the scatter kernel, csrc/
                   hash_scatter.cu, runs in the hash encode's backward)

Times are the best of 3 blocks of 10 calls ending in a synchronize
(``torch_study.best_ms``): the JAX script's host readout exists for a
remote TPU runtime, the card is timed eagerly.  The stage functions take
their inputs (rays, per-ray jitter, grid) explicitly.

Usage: python scripts/bench_torch_step_ablation.py [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torch_study import NERF_INTRINSICS, best_ms, device_line  # noqa: E402
from stable_nerf_tpu_torch.config import NeRFConfig  # noqa: E402
from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.grid import grid_init  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.network import (_mlp_apply, nerf_color,  # noqa: E402
                                                       nerf_init)
from stable_nerf_tpu_torch.models.nerf.renderer import render  # noqa: E402
from stable_nerf_tpu_torch.ops.compaction import compact_plan, gather_compact  # noqa: E402
from stable_nerf_tpu_torch.ops.marching import march_rays_lattice  # noqa: E402
from stable_nerf_tpu_torch.ops.ray_ops import near_far_from_aabb  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402
from stable_nerf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

MAX_STEPS = 256
BUDGET = 2 ** 18


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _aabb(cfg: NeRFConfig, device) -> torch.Tensor:
    b = cfg.bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)


def stage_march(cfg: NeRFConfig, occ, o, d, noise, max_steps: int = MAX_STEPS):
    """near/far + the lattice march with per-ray jitter ``noise``:
    (positions [N, K, 3], valid [N, K])."""
    nears, fars = near_far_from_aabb(o, d, _aabb(cfg, o.device), cfg.min_near)
    pos, _, _, valid, _ = march_rays_lattice(
        o, d, nears, fars, occ, bound=cfg.bound, cascade=cfg.cascade,
        grid_size=cfg.grid_size, max_steps=max_steps, noise=noise)
    return pos, valid


def stage_compact(cfg: NeRFConfig, occ, o, d, noise, budget: int = BUDGET):
    """+ the budget packing: (packed positions [budget, 3], the kept mask)."""
    pos, valid = stage_march(cfg, occ, o, d, noise)
    plan = compact_plan(valid, budget)
    return gather_compact(plan, pos), plan.new_valid


def stage_mlp_nohash(params, cfg: NeRFConfig, occ, o, d, noise, budget: int = BUDGET):
    """+ both MLPs in bf16 on a hash-free stand-in encode (the packed
    positions tiled to the encoder's width, 32 features at the flagship):
    (sigma [budget], color)."""
    pos_c, _ = stage_compact(cfg, occ, o, d, noise, budget)
    width = cfg.encoding_sigma.output_dim
    h = pos_c.repeat(1, -(-width // 3))[:, :width].to(torch.bfloat16)
    h = _mlp_apply(params["sigma_mlp"], h, torch.bfloat16)
    sigma = torch.relu(h[..., 0]).float()
    color = nerf_color(params, torch.zeros_like(pos_c), h[..., 1:], cfg, torch.bfloat16)
    return sigma, color


def full_loss(params, cfg: NeRFConfig, grid, o, d, noise, budget: int = BUDGET):
    """The render's loss mean |image − 0.5| (bf16, budget, per-ray jitter;
    the stochastic encode where ``cfg.hash_stochastic``)."""
    out = render(params, grid, o, d, cfg, bg_color=1.0, max_steps=MAX_STEPS, perturb=noise,
                 compute_dtype=torch.bfloat16, sample_budget=budget)
    return (out["image"] - 0.5).abs().mean()


def full_grad(params, cfg: NeRFConfig, grid, o, d, noise, budget: int = BUDGET):
    """The loss's gradient of every NeRF param, in ``tree_leaves`` order."""
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    return torch.autograd.grad(full_loss(params, cfg, grid, o, d, noise, budget), leaves)


def setup(cfg: NeRFConfig, device, n_poses: int = 2, hw: int = 64, seed: int = 0):
    """The workload's params, all-occupied grid, flat rays and a generator
    for the per-ray jitter, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = nerf_init(seed, cfg, device=device)
    grid = grid_init(cfg, device=device)
    grid = grid._replace(occ=torch.ones_like(grid.occ))
    rays = get_rays(rand_poses(g, n_poses, radius=2.0), NERF_INTRINSICS, hw, hw)
    return params, grid, rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3), g


def run(device, cfg: NeRFConfig = NeRFConfig(channel_dim=4), n_poses: int = 2,
        hw: int = 64, budget: int = BUDGET, n_iters: int = 10) -> dict:
    """{stage: ms} of every stage at the given sizes (the JAX script's by
    default)."""
    params, grid, o, d, g = setup(cfg, device, n_poses, hw)
    noise = torch.rand(o.shape[0], generator=g, device=device)
    stoch = dataclasses.replace(cfg, hash_stochastic=True)

    def ms(fn):
        return best_ms(fn, device, n_iters)

    with torch.no_grad():
        rows = {"march": ms(lambda: stage_march(cfg, grid.occ, o, d, noise)),
                "march+compact": ms(lambda: stage_compact(cfg, grid.occ, o, d, noise,
                                                          budget)),
                "+mlps (no hash)": ms(lambda: stage_mlp_nohash(params, cfg, grid.occ, o, d,
                                                               noise, budget)),
                "full fwd (exact)": ms(lambda: full_loss(params, cfg, grid, o, d, noise,
                                                         budget)),
                "full fwd (stoch)": ms(lambda: full_loss(params, stoch, grid, o, d, noise,
                                                         budget))}
    rows["full fwd+bwd (exact)"] = ms(lambda: full_grad(params, cfg, grid, o, d, noise,
                                                        budget))
    rows["full fwd+bwd (stoch)"] = ms(lambda: full_grad(params, stoch, grid, o, d, noise,
                                                        budget))
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    disable_tf32()
    print(device_line(dev))
    for name, v in run(dev).items():
        print(f"{name + ':':<22}{v:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
