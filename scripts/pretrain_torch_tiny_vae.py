#!/usr/bin/env python
"""Pretrain the learned-diffusion demo's tiny VAE on the synthetic scene
with the PyTorch/CUDA port.

Counterpart of scripts/pretrain_tiny_vae.py, with its flags, defaults
and artifact: an AutoencoderKL of widths 32·2^i (one stage a halving of
the image, one resnet a stage, 8 norm groups) trained on the TRAIN split
of the synthetic scene (``split_dataset(seed)``, as the joint loop
splits it) with MSE reconstruction plus ``--kl-weight``·KL against
N(0, 1), Adam (0.9, 0.999, 1e-8) under optax's
``cosine_decay_schedule(lr, steps, alpha=0.02)``.  At the end the latent
std over the train views is measured and 1/std stored as the config's
scaling_factor, so the demo's diffusion runs on ~unit-variance latents.

Output: ``vae_save_npz``'s ``.npz`` (params, config, meta with the recon
PSNR of the train and test splits and the latent statistics), which
either package's ``train.py --demo --vae-checkpoint`` loads; then the
JAX script's final JSON line.  The default ``--out`` is beside, not over,
the committed JAX-trained ``runs/demo_vae/vae.npz``.

Usage: python scripts/pretrain_torch_tiny_vae.py [--out runs/demo_vae_torch/vae.npz]
       [--steps 4000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from stable_nerf_tpu_torch.config import TrainConfig  # noqa: E402
from stable_nerf_tpu_torch.data.dataset import split_dataset  # noqa: E402
from stable_nerf_tpu_torch.data.preprocess import load_data  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.vae import (VAEConfig,  # noqa: E402
                                                        vae_decode,
                                                        vae_encode_moments,
                                                        vae_init, vae_save_npz)
from stable_nerf_tpu_torch.training.joint import lr_factor  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402
from stable_nerf_tpu_torch.utils.losses import psnr  # noqa: E402
from stable_nerf_tpu_torch.utils.tree import tree_leaves  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/demo_vae_torch/vae.npz")
    ap.add_argument("--data-root", default="datasets")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--latent-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--kl-weight", type=float, default=1e-6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where it trains (default cuda; raises without a card)")
    return ap


def vae_config(image_size: int, latent_size: int) -> VAEConfig:
    """The tiny VAE for image = latent·2^k: k + 1 stages of widths 32·2^i,
    scaling factor 1 until the latent std is measured."""
    if image_size % latent_size:
        sys.exit("--image-size must be a multiple of --latent-size")
    factor = image_size // latent_size
    n_blocks = factor.bit_length()           # factor 2^(n_blocks - 1)
    if 2 ** (n_blocks - 1) != factor:
        sys.exit("image/latent ratio must be a power of two")
    return VAEConfig(block_out_channels=tuple(32 * 2 ** i for i in range(n_blocks)),
                     layers_per_block=1, norm_groups=8, scaling_factor=1.0)


def load_split(args, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scene's train and test views [N, 3, H, W] in [-1, 1]."""
    images, _, _ = load_data("synthetic", shape=(args.image_size,) * 2, root=args.data_root)
    images = torch.as_tensor(images, dtype=torch.float32)
    tr_idx, _, te_idx = split_dataset(len(images), seed=args.seed)
    return (images[torch.from_numpy(tr_idx)].to(device),
            images[torch.from_numpy(te_idx)].to(device))


def loss_fn(params: Dict, batch: torch.Tensor, eps: torch.Tensor, cfg: VAEConfig,
            kl_weight: float):
    """(MSE + kl_weight·KL, MSE, KL) of one batch, z = mean + std·eps
    decoded at scaling factor 1."""
    mean, logvar = vae_encode_moments(params, batch, cfg)
    z = mean + torch.exp(0.5 * logvar) * eps
    rec = ((vae_decode(params, z, cfg) - batch) ** 2).mean()
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(dim=(1, 2, 3)).mean()
    return rec + kl_weight * kl, rec, kl


def make_optimizer(params: Dict, args):
    """Adam with optax's defaults under ``cosine_decay_schedule(lr, steps,
    alpha=0.02)`` → (optimizer, LambdaLR)."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    factor = lr_factor(TrainConfig(lr_schedule="cosine", lr_decay_steps=args.steps,
                                   lr_decay_factor=0.02))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def train_step(params: Dict, opt, sched, batch: torch.Tensor, eps: torch.Tensor,
               cfg: VAEConfig, kl_weight: float):
    """One update on ``batch`` with the posterior draw ``eps``; returns
    (loss, rec, kl) tensors, not synchronised."""
    loss, rec, kl = loss_fn(params, batch, eps, cfg, kl_weight)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach(), rec.detach(), kl.detach()


@torch.no_grad()
def eval_recon(params: Dict, images: torch.Tensor, cfg: VAEConfig):
    """Per-image PSNR [N, 1] of the mode reconstruction, and the mode
    latents."""
    mean, _ = vae_encode_moments(params, images, cfg)
    recon = vae_decode(params, mean, cfg)
    a = torch.clamp((recon + 1) / 2, 0, 1)
    b = torch.clamp((images + 1) / 2, 0, 1)
    return psnr(a, b), mean


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    cfg = vae_config(args.image_size, args.latent_size)
    print(f"VAE: {cfg.block_out_channels} image {args.image_size} -> "
          f"latent {args.latent_size}", flush=True)
    train_images, test_images = load_split(args, device)
    print(f"{len(train_images)} train / {len(test_images)} test views", flush=True)

    g = torch.Generator(device=device).manual_seed(args.seed)
    params = vae_init(g, cfg)
    print(f"{sum(x.numel() for x in tree_leaves(params)):,} VAE params", flush=True)
    opt, sched = make_optimizer(params, args)
    lat = args.latent_size
    t0 = time.perf_counter()
    n_train = train_images.shape[0]
    for step in range(args.steps):
        idx = torch.randint(0, n_train, (args.batch,), generator=g, device=device)
        eps = torch.randn((args.batch, cfg.latent_channels, lat, lat), generator=g,
                          device=device)
        loss, rec, kl = train_step(params, opt, sched, train_images[idx], eps, cfg,
                                   args.kl_weight)
        if step % 500 == 0 or step == args.steps - 1:
            p_tr, _ = eval_recon(params, train_images, cfg)
            p_te, _ = eval_recon(params, test_images, cfg)
            print(f"step {step}: loss {float(loss):.5f} rec {float(rec):.5f} "
                  f"kl {float(kl):.1f} | recon PSNR train {float(p_tr.mean()):.2f} "
                  f"test {float(p_te.mean()):.2f} dB "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    p_tr, lat_tr = eval_recon(params, train_images, cfg)
    p_te, _ = eval_recon(params, test_images, cfg)
    latent_std = float(lat_tr.std(unbiased=False))
    scaling = 1.0 / latent_std
    meta = {
        "recon_psnr_train": float(p_tr.mean()),
        "recon_psnr_test": float(p_te.mean()),
        "latent_std": latent_std,
        "latent_mean": float(lat_tr.mean()),
        "image_size": args.image_size,
        "latent_size": args.latent_size,
        "steps": args.steps,
        "seed": args.seed,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    cfg = dataclasses.replace(cfg, scaling_factor=scaling)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    vae_save_npz(args.out, params, cfg, meta=meta)
    out = {"artifact": args.out, **meta, "scaling_factor": scaling}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
