#!/usr/bin/env python
"""Validate an SDXL checkpoint end to end through the PyTorch/CUDA port
(counterpart of scripts/validate_sdxl_checkpoint.py, with its checks,
thresholds and report keys).

Point it at a checkpoint directory in the HF hub layout (vae/, unet/,
text_encoder/, text_encoder_2/) and it runs the reference's visual-parity
workloads (test_sd.py:23-168):

  1. the load, then a checksum of each subtree (leaf count, parameter
     count, L2 norm, SHA-256 of the float32 bytes in the JAX package's leaf
     order), equal to the JAX validator's on the same weights, so that two
     machines and two packages can compare their loads;
  2. the VAE round trip of a fixed test card: the latent's statistics and
     the reconstruction's PSNR, which must be finite and above 20 dB;
  3. the empty-prompt conditioning from the two CLIP text towers: finite,
     with a non-zero pooled embedding;
  4. a ``--steps`` DDIM denoise from pure noise with that conditioning
     (the U-Net in bf16, ``torch_study.sdxl_eps`` through
     ``DDIMScheduler.denoise``), decoded: finite, and not flat (std > 0.01);
     ``denoised.png`` (``.png.npy`` where PIL is absent).

Where the JAX script stops at the first failed check, this one runs every
check, writes ``report.json`` (the JAX script's keys, plus
``failed_checks``) either way, and exits non-zero naming the checks that
failed.  Weights drawn at random fail check 2 by design: a random VAE
reconstructs nothing.  The weights load into host memory (as the training
CLI loads them) and each model moves to ``--device`` (default cuda) for
its check.

Usage: python scripts/validate_torch_sdxl_checkpoint.py --checkpoint DIR
       [--skip-denoise] [--steps 50] [--out debug_out/sdxl]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stable_nerf_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

MIN_RECON_PSNR_DB = 20.0
MIN_IMAGE_STD = 0.01


def tree_checksum(tree) -> dict:
    """Leaf count, parameter count, L2 norm and the first 16 hex digits of
    the SHA-256 of every leaf's float32 bytes, in the JAX package's leaf
    order (dict keys sorted): the JAX validator's record of the same
    tree."""
    leaves = tree_leaves(tree)
    h = hashlib.sha256()
    total, sq = 0, 0.0
    for leaf in leaves:
        arr = leaf.detach().to("cpu", torch.float32).contiguous().numpy()
        h.update(arr.tobytes())
        total += arr.size
        sq += float((arr.astype(np.float64) ** 2).sum())
    return {"leaves": len(leaves), "params": total,
            "l2": round(float(np.sqrt(sq)), 4), "sha256": h.hexdigest()[:16]}


def test_image(size: int = 512) -> np.ndarray:
    """The fixed smooth test card in [-1, 1], [1, 3, size, size]."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = np.sin(6.28 * x) * np.cos(3.14 * y)
    g = np.clip(2 * ((x - 0.5) ** 2 + (y - 0.5) ** 2) ** 0.5, 0, 1) * 2 - 1
    b = np.sin(12.56 * (x + y)) * 0.5
    return np.stack([r, g, b])[None]


def vae_round_trip(vae_params, img, vae_cfg, eps=None, generator=None):
    """Encode (a sample, normal draw ``eps`` or from ``generator``) and
    decode ``img``: (latents, reconstruction, the report's ``vae`` entry)."""
    from stable_nerf_tpu_torch.models.diffusion.vae import vae_decode, vae_encode_sample
    from stable_nerf_tpu_torch.utils.losses import psnr

    with torch.no_grad():
        lat = vae_encode_sample(vae_params, img, vae_cfg, eps=eps, generator=generator)
        rec = vae_decode(vae_params, lat, vae_cfg)
    rec_psnr = float(psnr(torch.clamp((rec + 1) / 2, 0, 1),
                          torch.clamp((img + 1) / 2, 0, 1))[0, 0])
    return lat, rec, {"latent_shape": list(lat.shape),
                      "latent_mean": round(float(lat.mean()), 4),
                      "latent_std": round(float(lat.std(correction=0)), 4),
                      "reconstruction_psnr_db": round(rec_psnr, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", default="debug_out/sdxl")
    ap.add_argument("--skip-denoise", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from torch_study import sdxl_eps
    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig, vae_decode
    from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device

    dev = resolve_device(args.device)
    disable_tf32()
    os.makedirs(args.out, exist_ok=True)
    report, failed = {}, []

    def check(name, ok, why):
        if not ok:
            failed.append(name)
            print(f"CHECK FAILED: {name}: {why}")

    def to_dev(tree, dtype=None):
        cast = dtype is not None
        return tree_map(lambda x: x.to(dev, dtype) if cast and x.is_floating_point()
                        else x.to(dev), tree)

    # -- 1. load + checksums ------------------------------------------
    print(f"loading {args.checkpoint} …")
    params = load_sdxl(args.checkpoint, device="cpu")
    for name in sorted(params):
        cs = tree_checksum(params[name])
        report[f"checksum/{name}"] = cs
        print(f"  {name}: {cs}")
    vae_cfg = VAEConfig()                  # the defaults are SDXL's
    unet_cfg = sdxl_unet_config()

    # -- 2. VAE round trip --------------------------------------------
    vae = to_dev(params.pop("vae"))
    img = torch.from_numpy(test_image()).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    _, _, report["vae"] = vae_round_trip(vae, img, vae_cfg, generator=g)
    rec_psnr = report["vae"]["reconstruction_psnr_db"]
    print(f"VAE roundtrip: latent std {report['vae']['latent_std']}, "
          f"reconstruction PSNR {rec_psnr:.2f} dB")
    check("vae_reconstruction_psnr", math.isfinite(rec_psnr) and rec_psnr > MIN_RECON_PSNR_DB,
          f"{rec_psnr} dB, not above {MIN_RECON_PSNR_DB}: the VAE does not reconstruct "
          "(converter key mapping, or weights that were never trained)")

    # -- 3. empty-prompt conditioning ---------------------------------
    if "text_encoder" in params and "text_encoder_2" in params:
        from stable_nerf_tpu_torch.models.diffusion.clip_text import (
            make_empty_prompt_conditioning)

        with torch.no_grad():
            embeds, pooled, _ = make_empty_prompt_conditioning(
                to_dev(params.pop("text_encoder")), to_dev(params.pop("text_encoder_2")))
        report["empty_prompt"] = {
            "embeds_norm": round(float(torch.linalg.norm(embeds)), 4),
            "pooled_norm": round(float(torch.linalg.norm(pooled)), 4),
        }
        print(f"empty-prompt conditioning: {report['empty_prompt']}")
        check("empty_prompt_pooled_nonzero", float(torch.linalg.norm(pooled)) > 0,
              "the pooled embeds are zero")
        check("empty_prompt_finite", bool(torch.isfinite(embeds).all()),
              "the prompt embeds are not finite")
        del embeds
    else:
        pooled = torch.zeros((1, unet_cfg.pooled_projection_dim), device=dev)
        report["empty_prompt"] = "text encoders missing — zeros fallback"
        print("WARNING: no text_encoder dirs; skipping conditioning check")

    # -- 4. DDIM denoise ----------------------------------------------
    if not args.skip_denoise:
        B, H = 1, 64
        unet = to_dev(params.pop("unet"), torch.bfloat16)
        latents = torch.randn((B, 4, H, H), generator=g, device=dev)
        print(f"{args.steps}-step DDIM denoise …")
        final = DDIMScheduler.create(device=dev).denoise(
            sdxl_eps(unet, unet_cfg, B, dev, pooled=pooled[:B]), latents, args.steps)
        del unet
        with torch.no_grad():
            image = vae_decode(vae, final, vae_cfg)
        arr = torch.clamp((image + 1) / 2, 0, 1)[0].permute(1, 2, 0).cpu().numpy()
        report["denoise"] = {
            "latent_std": round(float(final.std(correction=0)), 4),
            "image_mean": round(float(arr.mean()), 4),
            "image_std": round(float(arr.std()), 4),
            "finite": bool(np.all(np.isfinite(arr))),
        }
        print(f"denoise: {report['denoise']}")
        check("denoise_finite", report["denoise"]["finite"], "non-finite denoise output")
        check("denoise_not_flat", report["denoise"]["image_std"] > MIN_IMAGE_STD,
              "the denoised image is flat: conditioning or scheduler broken")
        from stable_nerf_tpu_torch.utils.visualization import save_image

        save_image(os.path.join(args.out, "denoised.png"), arr)

    report["failed_checks"] = failed
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    if failed:
        print(f"\nCHECKS FAILED: {failed} — report at {args.out}/report.json")
        return 1
    print(f"\nALL CHECKS PASSED — report at {args.out}/report.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
