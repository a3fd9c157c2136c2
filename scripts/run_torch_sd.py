#!/usr/bin/env python
"""Stable Diffusion on its own through the PyTorch/CUDA port: a VAE round
trip and a full DDIM denoise (counterpart of scripts/run_sd.py; reference
test_sd.py: test_vae / test_image_reconstruction at :23-101,
test_sd_denoise at :104-168).

Encodes an image through the VAE and prints the latent's statistics and
the reconstruction's MSE (``vae_recon.png``), then runs a ``--steps``
DDIM denoise from zero image conditioning through ``sd_forward`` in bf16,
timed cold and steady, and decodes it (``denoised.png``).  Images are
written as PNG where PIL is installed, else as ``<name>.png.npy`` (uint8),
as the JAX package does.

Without ``--sdxl-checkpoint`` the models are the full-size architectures
with random weights from seed 0 (``--tiny``: the tiny configs); with a
checkpoint directory in the HF hub layout the U-Net and VAE are its
weights.  ``--image`` (a PNG) decodes through the native loader and is
resized with the antialiased bilinear filter of data/preprocess.py (the
card's machine has no PIL).  ``--sp`` / ``--tp`` > 1 are refused:
sequence- and tensor-parallel serving is not ported (ROADMAP.md §1,
``parallel/``).  ``--device`` (default cuda) is the one flag the JAX
script lacks.

Usage: python scripts/run_torch_sd.py [--tiny] [--size 512] [--steps 50]
       [--sdxl-checkpoint DIR] [--image PNG] [--out debug_out_sd]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stable_nerf_tpu_torch.config import SDConfig  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.sd_network import (  # noqa: E402
    SDNetworkConfig, decode_latents, encode_images, init_ip_from_unet, sd_forward,
    sd_network_init)
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402
from stable_nerf_tpu_torch.utils.visualization import save_image  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image", default=None, help="input PNG (default: noise)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sdxl-checkpoint", default=None)
    ap.add_argument("--tiny", action="store_true", help="tiny configs")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel axis size; only 1 is ported")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel axis size; only 1 is ported")
    ap.add_argument("--out", default="debug_out_sd")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def network_config(tiny: bool, size: int) -> SDNetworkConfig:
    """run_sd.py's configs: the tiny stack at ≤ 64² images, else full SDXL
    at ``size``² images."""
    if tiny:
        from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
        from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig

        size = min(size, 64)
        return SDNetworkConfig(
            sd=SDConfig(cross_attention_dim=48, latent_size=size // 2, image_size=size),
            unet=tiny_unet_config(),
            vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8))
    return SDNetworkConfig(sd=SDConfig(image_size=size))


def load_image(path: str, size: int) -> torch.Tensor:
    """A PNG → [1, 3, size, size] float32 in [-1, 1]: the native decoder,
    then the antialiased bilinear resize of data/preprocess.py."""
    from stable_nerf_tpu_torch.data.native_loader import decode_png_uint8
    from stable_nerf_tpu_torch.data.preprocess import resize_bilinear_uint8

    with open(path, "rb") as f:
        rgb = decode_png_uint8(f.read())
    rgb = resize_bilinear_uint8(rgb[None], (size, size))[0]
    x = rgb.astype(np.float32) / 127.5 - 1.0
    return torch.from_numpy(x.transpose(2, 0, 1).copy())[None]


def vae_round_trip(params, x, cfg: SDNetworkConfig, eps=None, generator=None):
    """Encode (a sample of the latent distribution, normal draw ``eps`` or
    from ``generator``) and decode: (latents, reconstruction, stats) with
    the latent's mean, std, min and max and the reconstruction's MSE."""
    with torch.no_grad():
        lat = encode_images(params, x, cfg, eps=eps, generator=generator)
        recon = decode_latents(params, lat, cfg)
    stats = {"latent_mean": float(lat.mean()), "latent_std": float(lat.std(correction=0)),
             "latent_min": float(lat.min()), "latent_max": float(lat.max()),
             "recon_mse": float(((recon - x) ** 2).mean())}
    return lat, recon, stats


def denoise(params, latents, cond, cfg: SDNetworkConfig, scheduler: DDIMScheduler,
            n_steps: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The DDIM loop of run_sd.py: ``n_steps`` eta-0 steps from
    ``latents``, each an ``sd_forward`` on the image conditioning
    ``cond`` [2B, cond_channels, h, w] in ``compute_dtype``."""
    ts = torch.as_tensor(scheduler.timesteps(n_steps), device=latents.device)
    x = latents
    with torch.no_grad():
        for t in ts:
            eps = sd_forward(params, x, t, cond, cfg, compute_dtype=compute_dtype)
            x, _ = scheduler.step(eps, t, x, num_inference_steps=n_steps)
    return x


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sp > 1 or args.tp > 1:
        print(f"--sp {args.sp} --tp {args.tp}: sequence- and tensor-parallel serving is "
              "not ported yet (ROADMAP.md §1 queue: parallel/)", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    disable_tf32()
    cfg = network_config(args.tiny, args.size)
    size = cfg.sd.image_size

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    params = sd_network_init(0, cfg, device=dev)
    if args.sdxl_checkpoint:
        from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl

        # the text towers go unused: the denoise is conditioned on zeros
        loaded = load_sdxl(args.sdxl_checkpoint, with_text_encoders=False,
                           unet_cfg=cfg.unet, vae_cfg=cfg.vae, device=dev)
        params.update(loaded)
        del loaded
    params = init_ip_from_unet(params)
    scheduler = DDIMScheduler.create(cfg.scheduler, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    if args.image:
        x = load_image(args.image, size).to(dev)
    else:
        x = torch.rand((1, 3, size, size), generator=g, device=dev) * 2 - 1
    os.makedirs(args.out, exist_ok=True)

    # 1. VAE round trip (reference test_sd.py:23-101)
    lat, recon, stats = vae_round_trip(params, x, cfg, generator=g)
    print(f"latents: shape {tuple(lat.shape)} mean {stats['latent_mean']:.4f} "
          f"std {stats['latent_std']:.4f} min {stats['latent_min']:.3f} "
          f"max {stats['latent_max']:.3f}")
    print(f"VAE reconstruction MSE: {stats['recon_mse']:.5f}")
    save_image(os.path.join(args.out, "vae_recon.png"),
               torch.clamp((recon[0] + 1) / 2, 0, 1), chw=True)

    # 2. a full DDIM denoise with zero image conditioning (reference
    #    test_sd.py:104-168; the tokens come from zeroed ip-condition
    #    images through the projection path)
    enc = cfg.sd.latent_size
    cond = torch.zeros((2, cfg.sd.cond_channels, enc, enc), device=dev)
    latents = torch.randn(lat.shape, generator=g, device=dev)
    sync()
    t0 = time.perf_counter()
    latents = denoise(params, latents, cond, cfg, scheduler, args.steps)
    sync()
    dt = time.perf_counter() - t0
    print(f"{args.steps}-step DDIM denoise: {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s incl. the first call's set-up)")
    t0 = time.perf_counter()
    denoise(params, latents, cond, cfg, scheduler, args.steps)
    sync()
    dt = time.perf_counter() - t0
    print(f"steady-state: {args.steps / dt:.2f} denoise steps/s")

    with torch.no_grad():
        img = decode_latents(params, latents.float(), cfg)
    save_image(os.path.join(args.out, "denoised.png"),
               torch.clamp((img[0] + 1) / 2, 0, 1), chw=True)
    print(f"outputs written to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
