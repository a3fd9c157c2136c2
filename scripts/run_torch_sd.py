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
card's machine has no PIL).

``--sp S`` / ``--tp T`` > 1 serve the denoise sequence- and
tensor-parallel, as run_sd.py does under ``shard_map``: one process a
rank, on a (data × seq × model) mesh of ``parallel/sharding.py::
make_mesh_3d``; the U-Net's attention heads and GEGLU width cut over the
model axis (``parallel/tp.py::shard_unet_for_tp``), its latent tokens
over the seq axis (ring attention); the VAE round trip and the
conditioning path replicated.  Every rank draws the same latents (the
generator is not folded with the rank); rank 0 prints and writes.
Without ``--coordinator`` the script starts S·T processes of itself, one
a card (``train.launch_local``), and refuses to run with fewer cards than
that, as run_sd.py refuses with fewer devices; with ``--coordinator
HOST:PORT --num-processes N --process-id I`` it is one rank of a world
started by hand (N a multiple of S·T; the data axis replicates).  On the
CPU (``--device cpu``) the ranks are started by hand or by a launcher,
over gloo.  ``--device`` (default cuda) and the three rank flags are the
flags the JAX script lacks.

Usage: python scripts/run_torch_sd.py [--tiny] [--size 512] [--steps 50]
       [--sdxl-checkpoint DIR] [--image PNG] [--out debug_out_sd]
       [--sp S] [--tp T] [--coordinator HOST:PORT --num-processes N --process-id I]
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
                    help="sequence-parallel axis size for the denoise (ring attention "
                         "over latent tokens; needs sp*tp processes)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel axis size for the denoise (attention-head/"
                         "GEGLU sharding)")
    ap.add_argument("--out", default="debug_out_sd")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0's store: run as one rank of a world started "
                         "by hand (with --num-processes and --process-id)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
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


def _axes(mesh):
    """(tp_axis, sp_axis) of a (data × seq × model) mesh, None where an
    axis has size 1 (or without a mesh)."""
    if mesh is None:
        return None, None
    return (mesh.axes["model"] if mesh.shape["model"] > 1 else None,
            mesh.axes["seq"] if mesh.shape["seq"] > 1 else None)


def shard_params(params, mesh):
    """This rank's serving params: with a model axis the U-Net's GEGLU
    kernels permuted and its attention and GEGLU leaves cut to this rank's
    slices (``parallel/tp.py::shard_unet_for_tp``, the cut of
    ``serving_param_specs``' specs); every other leaf whole."""
    from stable_nerf_tpu_torch.parallel.tp import shard_unet_for_tp

    tp_axis, _ = _axes(mesh)
    if tp_axis is None:
        return params
    return {**params, "unet": shard_unet_for_tp(params["unet"], tp_axis)}


def denoise(params, latents, cond, cfg: SDNetworkConfig, scheduler: DDIMScheduler,
            n_steps: int, compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """The DDIM loop of run_sd.py: ``n_steps`` eta-0 steps from
    ``latents``, each an ``sd_forward`` on the image conditioning
    ``cond`` [2B, cond_channels, h, w] in ``compute_dtype``.  With a
    (data × seq × model) ``mesh`` the U-Net runs tensor-parallel over its
    model axis and sequence-parallel over its seq axis on ``params`` cut
    by :func:`shard_params`; every rank passes the same latents and gets
    the same result."""
    tp_axis, sp_axis = _axes(mesh)
    return scheduler.denoise(
        lambda x, t: sd_forward(params, x, t, cond, cfg, compute_dtype=compute_dtype,
                                tp_axis=tp_axis, sp_axis=sp_axis),
        latents, n_steps)


def launch_ranks(args, argv) -> int:
    """sp·tp processes of this script, one a card, each given the rank
    flags; refused (exit 1) with fewer cards than that.  Returns the first
    non-zero exit code of a rank, else 0."""
    from stable_nerf_tpu_torch.train import launch_local

    need = args.sp * args.tp
    dev = resolve_device(args.device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if have < need:
        print(f"--sp {args.sp} --tp {args.tp} needs {need} devices, have {have}",
              file=sys.stderr)
        return 1
    argv = list(argv if argv is not None else sys.argv[1:])
    return launch_local(argv, need, command=[sys.executable, os.path.abspath(__file__)])


def join_mesh(args):
    """This rank's (data × seq × model) mesh of the world ``--coordinator``
    names, on its card (NCCL) or the CPU (gloo); None without
    ``--coordinator``."""
    from stable_nerf_tpu_torch.parallel.sharding import make_mesh_3d

    if args.coordinator is None:
        return None
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    return make_mesh_3d(device, sp=args.sp, tp=args.tp,
                        init_method=f"tcp://{args.coordinator}", rank=args.process_id,
                        world_size=args.num_processes)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    need = args.sp * args.tp
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            print("--coordinator requires --num-processes and --process-id", file=sys.stderr)
            return 2
        if args.num_processes < need or args.num_processes % need:
            print(f"--sp {args.sp} --tp {args.tp} needs {need} processes (or a multiple), "
                  f"have {args.num_processes}", file=sys.stderr)
            return 1
    elif need > 1:
        return launch_ranks(args, argv)
    mesh = join_mesh(args)
    try:
        return run(args, mesh)
    finally:
        if mesh is not None:
            from stable_nerf_tpu_torch.parallel.sharding import close_mesh

            close_mesh()


def run(args, mesh) -> int:
    """The VAE round trip and the denoise on this process (one rank of
    ``mesh`` where it is given; rank 0 prints and writes)."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
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
    if lead:
        os.makedirs(args.out, exist_ok=True)

    # 1. VAE round trip (reference test_sd.py:23-101), on every rank
    lat, recon, stats = vae_round_trip(params, x, cfg, generator=g)
    say(f"latents: shape {tuple(lat.shape)} mean {stats['latent_mean']:.4f} "
        f"std {stats['latent_std']:.4f} min {stats['latent_min']:.3f} "
        f"max {stats['latent_max']:.3f}")
    say(f"VAE reconstruction MSE: {stats['recon_mse']:.5f}")
    if lead:
        save_image(os.path.join(args.out, "vae_recon.png"),
                   torch.clamp((recon[0] + 1) / 2, 0, 1), chw=True)

    # 2. a full DDIM denoise with zero image conditioning (reference
    #    test_sd.py:104-168; the tokens come from zeroed ip-condition
    #    images through the projection path)
    enc = cfg.sd.latent_size
    cond = torch.zeros((2, cfg.sd.cond_channels, enc, enc), device=dev)
    latents = torch.randn(lat.shape, generator=g, device=dev)
    local = shard_params(params, mesh)
    if mesh is not None:
        say(f"denoising sharded: seq={args.sp} model={args.tp} over {mesh.world} "
            f"processes ({mesh.backend})")
    sync()
    t0 = time.perf_counter()
    latents = denoise(local, latents, cond, cfg, scheduler, args.steps, mesh=mesh)
    sync()
    dt = time.perf_counter() - t0
    say(f"{args.steps}-step DDIM denoise: {dt:.1f}s "
        f"({args.steps / dt:.2f} steps/s incl. the first call's set-up)")
    t0 = time.perf_counter()
    denoise(local, latents, cond, cfg, scheduler, args.steps, mesh=mesh)
    sync()
    dt = time.perf_counter() - t0
    say(f"steady-state: {args.steps / dt:.2f} denoise steps/s")

    if lead:
        with torch.no_grad():
            img = decode_latents(params, latents.float(), cfg)
        save_image(os.path.join(args.out, "denoised.png"),
                   torch.clamp((img[0] + 1) / 2, 0, 1), chw=True)
    say(f"outputs written to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
