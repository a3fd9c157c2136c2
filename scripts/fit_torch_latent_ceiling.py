#!/usr/bin/env python
"""Attainable latent-PSNR ceiling of the learning demo, with the
PyTorch/CUDA port.

Counterpart of scripts/fit_latent_ceiling.py, with its flags and final
JSON line.  The joint loop supervises its NeRF toward the normalized mode
latents (lt + 1) / 2 of the scene's views; this script overfits the NeRF
alone (channel_dim 4, 64² or the artifact's latent rays, the fit
harness's recipe: random-ray batches, Adam 1e-2 with exponential decay,
the joint loop's L1) on exactly those targets, and reports the mean
latent PSNR over views in three eval variants (train-matched: 256 steps
at the train budget; metric-style: 512 steps at the same budget; exact:
512 steps dense), beside the constant-mean floor.

``--vae-checkpoint`` (a tiny-VAE artifact of either package): the
artifact's VAE in float32, its image and latent sizes, the geometric
intrinsics, trunc_exp density.  Without it the VAE is the port's own
seed-``--seed`` init of the full SDXL VAE, stored in bf16 as
``--frozen-bf16`` stores it: the VAE the port's joint loop builds from
that seed (``sd_network_init`` draws it first).  It is not the JAX
package's, which comes from JAX's key path, so that path's numbers are
the port's own and are not compared with the JAX script's.

Usage: python scripts/fit_torch_latent_ceiling.py [--steps 3000] [--views 8]
       [--vae-checkpoint runs/demo_vae/vae.npz] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fit_torch_nerf import make_optimizer, refresh, train_step  # noqa: E402
from stable_nerf_tpu_torch.config import NeRFConfig, SDConfig  # noqa: E402
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.sd_network import (  # noqa: E402
    SDNetworkConfig, encode_images_mode)
from stable_nerf_tpu_torch.models.diffusion.vae import vae_init, vae_load_npz  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.grid import grid_init, mark_untrained_grid  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.network import nerf_init  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.renderer import render  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402
from stable_nerf_tpu_torch.utils.losses import psnr  # noqa: E402
from stable_nerf_tpu_torch.utils.tree import tree_map  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0,
                    help="the demo's seed (the random VAE's and the NeRF's)")
    ap.add_argument("--sample-budget", type=int, default=2 ** 18)
    ap.add_argument("--update-every", type=int, default=16)
    ap.add_argument("--views", type=int, default=8, help="views for the final PSNR report")
    ap.add_argument("--loss", default="l1", choices=["l1", "mse"],
                    help="l1 = the joint loop's nerf_loss")
    ap.add_argument("--vae-checkpoint", default=None,
                    help="a tiny-VAE artifact: measure the ceiling against its latents, "
                         "at its image/latent sizes with the geometric intrinsics")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where it runs (default cuda; raises without a card)")
    return ap


def latent_targets(args, device: torch.device) -> Dict:
    """The dataset at the VAE's sizes and its views' normalized mode
    latents ``target`` [N, 4, h, w] = (lt + 1) / 2, encoded one view at a
    time."""
    sd_cfg = SDNetworkConfig()
    scale_intrinsics = False
    if args.vae_checkpoint:
        vae_params, vae_cfg, meta = vae_load_npz(args.vae_checkpoint, device=device)
        sd_cfg = SDNetworkConfig(sd=SDConfig(latent_size=meta.get("latent_size", 16),
                                             image_size=meta.get("image_size", 64)),
                                 vae=vae_cfg)
        scale_intrinsics = True
    else:
        g = torch.Generator(device=device).manual_seed(args.seed)
        vae_params = tree_map(lambda x: x.to(torch.bfloat16), vae_init(g, sd_cfg.vae))
    ds = StableNeRFDataset("synthetic", shape=sd_cfg.sd.image_size,
                           encoded_shape=sd_cfg.sd.latent_size,
                           scale_intrinsics=scale_intrinsics)
    images = torch.from_numpy(ds.reference_images).to(device)
    with torch.no_grad():
        lts = [encode_images_mode({"vae": vae_params}, images[i:i + 1], sd_cfg)
               for i in range(len(ds))]
    return {"ds": ds, "target": (torch.cat(lts) + 1.0) / 2.0,
            "latent": sd_cfg.sd.latent_size}


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    tg = latent_targets(args, device)
    ds, target, enc = tg["ds"], tg["target"], tg["latent"]
    n = len(ds)
    t_stats = {"mean": float(target.mean()), "std": float(target.std(unbiased=False)),
               "min": float(target.min()), "max": float(target.max())}
    print(f"latent targets: {t_stats}", file=sys.stderr, flush=True)

    cfg = NeRFConfig(channel_dim=4,
                     density_activation="trunc_exp" if args.vae_checkpoint else "relu")
    params = nerf_init(args.seed, cfg, device=device)
    rays_o = torch.from_numpy(ds.reference_rays["rays_o"]).to(device)   # [N, h·w, 3]
    rays_d = torch.from_numpy(ds.reference_rays["rays_d"]).to(device)
    state = mark_untrained_grid(grid_init(cfg, device=device),
                                torch.from_numpy(ds.reference_poses).to(device),
                                ds.intrinsic, cfg)
    opt, sched = make_optimizer(params, args.lr, args.steps, 0.1)
    gts = target.permute(0, 2, 3, 1).reshape(n, -1, 4)
    pool = {"pool_o": rays_o.reshape(-1, 3), "pool_d": rays_d.reshape(-1, 3),
            "pool_gt": gts.reshape(-1, 4)}

    # train-matched: what the fit reaches; metric-style: the demo metric's
    # shape (512 steps, same budget: compaction drops another part of the
    # lattice than the 256-step train render did); exact: no compaction
    evals = {"train_matched_256": (256, args.sample_budget),
             "metric_style_512": (512, args.sample_budget),
             "exact_dense_512": (512, None)}

    @torch.no_grad()
    def view_psnr(i, variant="train_matched_256"):
        steps, budget = evals[variant]
        pred = render(params, state, rays_o[i][None], rays_d[i][None], cfg, bg_color=1.0,
                      max_steps=steps, sample_budget=budget)["image"][0]
        return float(psnr(pred.reshape(1, enc, enc, 4).permute(0, 3, 1, 2),
                          target[i:i + 1])[0, 0])

    def mean_baseline_psnr(i):
        """A constant at the global latent mean: the floor any renderer
        reaches without 3-D structure."""
        b = target[i:i + 1]
        return float(psnr(torch.full_like(b, float(target.mean())), b)[0, 0])

    g = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        if step % args.update_every == 0:
            state = refresh(state, params, cfg, generator=g)
        idx = torch.randint(0, pool["pool_o"].shape[0], (args.rays_per_batch,),
                            generator=g, device=device)
        perturb = torch.rand(args.rays_per_batch, generator=g, device=device)
        loss = train_step(params, opt, sched, state, pool, cfg, idx, perturb, bg=1.0,
                          max_steps=256, loss=args.loss, budget=args.sample_budget)
        if (step + 1) % 250 == 0 or step == 0:
            print(f"step {step + 1}: loss {float(loss):.5f} view0 latent_psnr "
                  f"{view_psnr(0):.2f} ({time.time() - t0:.0f}s)", file=sys.stderr,
                  flush=True)

    nv = min(args.views, n)
    out = {}
    for name in evals:
        ps = [view_psnr(i, name) for i in range(nv)]
        out[name] = {"mean": round(float(np.mean(ps)), 2),
                     "per_view": [round(p, 2) for p in ps]}
    base = [mean_baseline_psnr(i) for i in range(nv)]
    result = {
        "ceiling_latent_psnr": out,
        "constant_mean_baseline_psnr": round(float(np.mean(base)), 2),
        "final_l1": round(float(loss), 5),
        "steps": args.steps,
        "target_stats": {k: round(v, 4) for k, v in t_stats.items()},
        "vae": args.vae_checkpoint or f"random seed-{args.seed} bf16 (the port's init)",
        "wall_s": round(time.time() - t0, 0),
        "note": ("NeRF-only overfit vs the deterministic latents of the named VAE, "
                 "normalized space — the attainable ceiling for the joint demo's "
                 "latent_psnr, with the constant-mean floor as the dynamic-range "
                 "denominator"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
