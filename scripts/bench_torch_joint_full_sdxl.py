#!/usr/bin/env python
"""Benchmark the real joint train step of the PyTorch/CUDA port on one
NVIDIA GPU: the full SDXL U-Net (2.57B) and VAE at 512² images / 64²
latents, forward, backward and AdamW (counterpart of
scripts/bench_joint_full_sdxl.py, with its flags and keys).

Dtype policy: the frozen weights (U-Net base and VAE) are stored in bf16;
the trainable partition (IP heads, image projection, downsampling CNN,
NeRF) and its AdamW moments stay float32.  The NeRF's sample budget is
2^18 for every 8,192 rays (``--batch`` × 2 views × 64²); the grid is all
occupied.

Usage: python scripts/bench_torch_joint_full_sdxl.py [--remat] [--iters N]
       [--blocks N] [--batch B] [--stochastic [--stochastic-min-level L]]

Prints one JSON line: ``joint_step_full_sdxl_ms`` (the best of
``--blocks`` blocks of ``--iters`` steps), ``views_per_sec``,
``unet_gflops_per_step_3xfwd`` (the analytic forward count × 3, forward
and backward; × 4/3 under ``--remat``, which recomputes each U-Net block's
forward in the backward), ``joint_unet_mfu_floor`` (that count over the step time and
the card's dense bf16 peak: a floor, since no frozen weight's gradient is
computed), ``device_kind``, ``hbm_gb``/``hbm_measure`` (the allocator's
peak from the first step on, the state included), ``first_step_s`` (the
first step's seconds, where bench_joint_full_sdxl.py reports the XLA
compile as ``compile_s``), parameter counts and ``loss``.  XLA's
``memory_analysis`` fields (``hbm_arguments_gb`` and the rest) have no
counterpart here and are left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def joint_config(stochastic: bool = False, batch: int = 1, stochastic_min_level: int = 0,
                 remat: bool = False):
    """The step's configuration: the flagship NeRF (the one-corner encode
    under ``stochastic``, the hybrid one with ``stochastic_min_level`` >
    0), the SDXL U-Net (its blocks recomputed in the backward under
    ``remat``), a 2^18 sample budget a sample, frozen weights in bf16."""
    from stable_nerf_tpu_torch.config import NeRFConfig, TrainConfig
    from stable_nerf_tpu_torch.models.diffusion.sd_network import SDNetworkConfig
    from stable_nerf_tpu_torch.models.diffusion.unet import UNetConfig
    from stable_nerf_tpu_torch.training.joint import JointConfig

    return JointConfig(
        nerf=NeRFConfig(channel_dim=4, hash_stochastic=stochastic,
                        hash_stochastic_min_level=stochastic_min_level),
        sd=SDNetworkConfig(unet=UNetConfig(remat=remat)),
        train=TrainConfig(batch_size=batch, max_steps_train=256,
                          sample_budget=batch * 2 ** 18, frozen_dtype="bfloat16"),
    )


def build(stochastic: bool = False, batch: int = 1, stochastic_min_level: int = 0,
          device=None, remat: bool = False):
    """Params (frozen partition in bf16), grid, optimizer, step and a batch
    of ``batch`` samples at full width, from seed 0 on ``device`` (default
    cuda); ``remat`` recomputes the U-Net's blocks in the backward."""
    import torch

    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import sd_network_init
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.training.joint import (cast_frozen, joint_trainable_mask,
                                                      make_optimizer, make_train_step)
    from stable_nerf_tpu_torch.utils.device import resolve_device
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    dev = resolve_device(device)
    cfg = joint_config(stochastic, batch, stochastic_min_level, remat)
    params = {"sd": sd_network_init(0, cfg.sd, device=dev),
              "nerf": nerf_init(1, cfg.nerf, device=dev)}
    mask = joint_trainable_mask(params)
    params = cast_frozen(params, mask, cfg.train.frozen_dtype)
    counts = [(x.numel(), m) for x, m in zip(tree_leaves(params), tree_leaves(mask))]
    sizes = {"trainable_params_m": round(sum(n for n, m in counts if m) / 1e6, 1),
             "frozen_params_m": round(sum(n for n, m in counts if not m) / 1e6, 1)}

    grid = grid_init(cfg.nerf, device=dev)
    grid = grid._replace(occ=torch.ones_like(grid.occ))
    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    opt = make_optimizer(cfg.train, params, mask)
    step = make_train_step(cfg, scheduler, opt, sample_budget=cfg.train.sample_budget,
                           device=dev)

    B, enc, img = batch, cfg.sd.sd.latent_size, cfg.sd.sd.image_size
    g = torch.Generator(device=dev).manual_seed(0)
    intr = (138.0, 138.0, enc / 2, enc / 2)
    rt = get_rays(rand_poses(g, B, radius=2.0), intr, enc, enc)
    rr = get_rays(rand_poses(g, B, radius=2.0), intr, enc, enc)
    # bench_joint_full_sdxl.py draws both images from one key: the same
    # image twice
    image = torch.rand((B, 3, img, img), generator=g, device=dev) * 2 - 1
    batch_d = {"target_image": image, "reference_image": image.clone(),
               "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
               "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"]}
    return params, grid, batch_d, step, g, sizes


def unet_step_flops(batch: int, remat: bool) -> float:
    """The U-Net's analytic FLOPs a step: the forward over 2·batch views ×
    3 (forward and a ~2× backward), × 4/3 under remat (the forward again
    in the backward)."""
    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config
    from stable_nerf_tpu_torch.utils.flops import unet_forward_flops

    flops = 3.0 * unet_forward_flops(sdxl_unet_config(), 2 * batch, 64)
    return flops * 4.0 / 3.0 if remat else flops


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--remat", action="store_true",
                    help="recompute the U-Net's resnet and transformer blocks in the "
                         "backward (less activation memory, ~4/3 the U-Net FLOPs)")
    ap.add_argument("--stochastic", action="store_true",
                    help="one-corner hash encode (the warm-up schedule's mode)")
    ap.add_argument("--stochastic-min-level", type=int, default=0,
                    help="with --stochastic: hybrid mode, levels below this exact "
                         "(0 = fully stochastic)")
    ap.add_argument("--batch", type=int, default=1,
                    help="samples a step (2 views each)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=3)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from torch_study import detect_peak_flops
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device
    from stable_nerf_tpu_torch.utils.profiling import measured_hbm_gb

    dev = resolve_device()
    disable_tf32()
    print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    t0 = time.perf_counter()
    params, grid, batch, step, g, sizes = build(args.stochastic, args.batch,
                                                args.stochastic_min_level, dev,
                                                remat=args.remat)
    torch.cuda.synchronize()
    print(f"built in {time.perf_counter() - t0:.1f}s  {sizes}", file=sys.stderr)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(params, grid, batch, generator=g)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    print(f"first step in {first_step_s:.2f}s", file=sys.stderr)

    best = float("inf")
    for _ in range(args.blocks):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            m = step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / args.iters)

    hbm_kind, hbm_gb = measured_hbm_gb()
    # the U-Net's share: analytic forward FLOPs × 3 (forward and a ~2×
    # backward; no frozen weight gradient is computed, so this MFU is a
    # floor) over the step time; the U-Net sees 2·batch views
    unet_flops = unet_step_flops(args.batch, args.remat)
    kind, peak = detect_peak_flops()
    result = {
        "joint_step_full_sdxl_ms": round(best * 1e3, 1),
        "batch": args.batch,
        "views_per_sec": round(2 * args.batch / best, 2),
        "unet_gflops_per_step_3xfwd": round(unet_flops / 1e9, 1),
        "joint_unet_mfu_floor": round(unet_flops / best / peak, 4) if peak else None,
        "device_kind": kind,
        "remat": args.remat,
        "stochastic": args.stochastic,
        "stochastic_min_level": args.stochastic_min_level,
        "dtype_policy": "frozen bf16 / trainable+moments f32",
        "hbm_gb": round(hbm_gb, 2),
        "hbm_measure": hbm_kind,
        "first_step_s": round(first_step_s, 2),
        **sizes,
        "loss": {k: float(v) for k, v in m.items()},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
