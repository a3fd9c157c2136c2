"""Joint Stable-NeRF training and inference driver of the PyTorch port
(counterpart of the repository's train.py, with the same flags and one
more, ``--device``).

Usage:
  python -m stable_nerf_tpu_torch.train --dataset synthetic     # train
  python -m stable_nerf_tpu_torch.train --inference --workdir X # restore + DDIM
  python -m stable_nerf_tpu_torch.train --tiny --dataset synthetic \\
      --image-size 32 --latent-size 16 --device cpu              # smoke run

Flags of paths the port does not have yet exit non-zero and name the
ROADMAP.md item that will port them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

NOT_PORTED = {
    "--data-parallel": "parallel/",
    "--tensor-parallel": "parallel/",
    "--fsdp": "parallel/",
    "--sp": "parallel/",
    "--distributed": "parallel/",
    "--coordinator": "parallel/",
    "--remat": "parallel/ (U-Net remat)",
    "--sdxl-checkpoint": "CLIP, the tokenizer and weights.py",
    "--demo": "the other scripts/ (the demo preset and its tiny VAE)",
    "--vae-checkpoint": "the other scripts/ (the demo preset and its tiny VAE)",
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default=None,
                   help="output directory (default: output_<timestamp>)")
    p.add_argument("--inference", action="store_true",
                   help="skip training; restore checkpoint and run inference")
    p.add_argument("--dataset", default="objaverse",
                   choices=["objaverse", "nerf", "synthetic"])
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--latent-size", type=int, default=64)
    p.add_argument("--percent-objects", type=float, default=0.0002)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--nerf-lr", type=float, default=None,
                   help="separate NeRF learning rate (a param group of its own); "
                        "omit for the reference's single AdamW lr")
    p.add_argument("--lr-schedule", default="constant",
                   choices=("constant", "exponential", "cosine"))
    p.add_argument("--lr-decay-steps", type=int, default=100_000,
                   help="optimizer steps over which the decay runs")
    p.add_argument("--lr-decay-factor", type=float, default=0.1,
                   help="final lr = lr x this factor")
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=256)
    p.add_argument("--max-steps-eval", type=int, default=512)
    p.add_argument("--inference-every", type=int, default=50)
    p.add_argument("--val-every", type=int, default=1,
                   help="validate every N epochs (1 = reference parity)")
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sdxl-checkpoint", default=None,
                   help="SDXL checkpoint dir (HF layout); not ported yet")
    p.add_argument("--sample-budget", default=None,
                   help="NeRF sample budget per step: an int (static), 'auto' "
                        "(re-bucketed at each occupancy refresh), or omitted for "
                        "dense unless the card's memory needs less")
    p.add_argument("--data-parallel", action="store_true", help="not ported yet")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="model-axis size; only 1 is ported")
    p.add_argument("--fsdp", action="store_true", help="not ported yet")
    p.add_argument("--frozen-bf16", action="store_true",
                   help="store the frozen partition (SDXL U-Net base + VAE) in "
                        "bfloat16 (must match across --resume)")
    p.add_argument("--remat", action="store_true", help="not ported yet")
    p.add_argument("--stochastic", action="store_true",
                   help="one-corner stochastic hash encode throughout training "
                        "(eval renders stay exact)")
    p.add_argument("--stochastic-until-epoch", type=int, default=0,
                   help="train the first N epochs with the stochastic encode, then "
                        "the exact one; 0 = no schedule")
    p.add_argument("--stochastic-min-level", type=int, default=0,
                   help="with --stochastic: keep levels < this exact (hybrid)")
    p.add_argument("--guidance-scale", type=float, default=1.0,
                   help="with --inference: classifier-free guidance scale; 1.0 = off")
    p.add_argument("--save-attn-maps", action="store_true",
                   help="with --inference: save the final DDIM step's ip-stream "
                        "cross-attention maps to renders/ip_attn_maps_<batch>.npz")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size; only 1 is ported")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="save a resumable checkpoint every N epochs (0 = only at "
                        "the end)")
    p.add_argument("--checkpoint-trainable-only", action="store_true",
                   help="checkpoint only the trainable partition + optimizer + "
                        "grid; the frozen partition is rebuilt on restore from "
                        "(seed, --frozen-bf16), recorded and verified in the "
                        "checkpoint dir's FORMAT.json")
    p.add_argument("--compile-cache", default=None,
                   help="the JAX package's compilation cache; ignored here")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under --workdir (params + "
                        "optimizer + occupancy grid + epoch) and continue")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of train steps 1-4 here")
    p.add_argument("--distributed", action="store_true", help="not ported yet")
    p.add_argument("--coordinator", default=None, help="not ported yet")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (smoke tests; pairs with --image-size "
                        "32 --latent-size 16)")
    p.add_argument("--demo", action="store_true", help="not ported yet")
    p.add_argument("--trainable-scope", default=None, choices=("reference", "sd"),
                   help="optimizer coverage: 'reference' = ip heads + NeRF (default); "
                        "'sd' = also the whole U-Net")
    p.add_argument("--vae-checkpoint", default=None, help="not ported yet")
    p.add_argument("--vae-encode", default=None, choices=("sample", "mode"),
                   help="latent-target encode: 'sample' (reference parity) or 'mode'")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port runs (default cuda; raises without a card)")
    return p


def _refused_flags(args) -> list:
    given = {
        "--data-parallel": args.data_parallel,
        "--tensor-parallel": args.tensor_parallel > 1,
        "--fsdp": args.fsdp,
        "--sp": args.sp > 1,
        "--distributed": args.distributed,
        "--coordinator": args.coordinator is not None,
        "--remat": args.remat,
        "--sdxl-checkpoint": args.sdxl_checkpoint is not None,
        "--demo": args.demo,
        "--vae-checkpoint": args.vae_checkpoint is not None,
    }
    return [flag for flag, on in given.items() if on]


def build_config(args):
    """The JointConfig that train.py builds from the same flags: the
    flagship, or the --tiny preset."""
    from .config import HashGridConfig, NeRFConfig, SDConfig, TrainConfig
    from .models.diffusion.sd_network import SDNetworkConfig
    from .models.diffusion.unet import tiny_unet_config
    from .models.diffusion.vae import VAEConfig
    from .training.joint import JointConfig

    if args.tiny:
        nerf_cfg = NeRFConfig(channel_dim=4, grid_size=32,
                              encoding_sigma=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                            base_resolution=4))
        sd_cfg = SDNetworkConfig(
            sd=SDConfig(latent_size=args.latent_size, image_size=args.image_size,
                        cross_attention_dim=48),
            unet=tiny_unet_config(),
            vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8))
    else:
        nerf_cfg = NeRFConfig(channel_dim=4)
        sd_cfg = SDNetworkConfig(sd=SDConfig(latent_size=args.latent_size,
                                             image_size=args.image_size))
    if args.stochastic:
        nerf_cfg = dataclasses.replace(nerf_cfg, hash_stochastic=True,
                                       hash_stochastic_min_level=args.stochastic_min_level)
    elif args.stochastic_until_epoch:
        # the loop flips hash_stochastic for the warm epochs; carry the
        # hybrid min level through
        nerf_cfg = dataclasses.replace(nerf_cfg,
                                       hash_stochastic_min_level=args.stochastic_min_level)
    return JointConfig(
        nerf=nerf_cfg, sd=sd_cfg,
        train=TrainConfig(
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            nerf_lr=args.nerf_lr, lr_schedule=args.lr_schedule,
            lr_decay_steps=args.lr_decay_steps, lr_decay_factor=args.lr_decay_factor,
            weight_decay=args.weight_decay, max_steps_train=args.max_steps,
            max_steps_eval=args.max_steps_eval, inference_every=args.inference_every,
            val_every=args.val_every, num_inference_steps=args.num_inference_steps,
            seed=args.seed,
            sample_budget=(None if args.sample_budget in (None, "auto")
                           else int(args.sample_budget)),
            sample_budget_auto=args.sample_budget == "auto",
            stochastic_until_epoch=args.stochastic_until_epoch,
            frozen_dtype="bfloat16" if args.frozen_bf16 else None,
            trainable_scope=args.trainable_scope or "reference",
            vae_encode=args.vae_encode or "sample",
            checkpoint_every=args.checkpoint_every,
            checkpoint_trainable_only=args.checkpoint_trainable_only))


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass

    refused = _refused_flags(args)
    if refused:
        sys.exit("not ported yet: " + "; ".join(
            f"{flag} (ROADMAP.md §1 queue: {NOT_PORTED[flag]})" for flag in refused))
    if args.compile_cache is not None:
        print("--compile-cache belongs to the JAX package; ignored")
    if args.stochastic and args.stochastic_until_epoch:
        sys.exit("--stochastic (one-corner encode throughout) and "
                 "--stochastic-until-epoch (warmup schedule, exact finish) are "
                 "mutually exclusive — pick one")
    if args.resume and not args.workdir:
        sys.exit("--resume requires --workdir (the run directory whose checkpoints "
                 "to continue from)")
    from datetime import datetime

    from .data.dataset import StableNeRFDataset
    from .utils.device import disable_tf32, resolve_device

    dev = resolve_device(args.device)
    disable_tf32()
    workdir = args.workdir or f"output_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    cfg = build_config(args)

    print(f"workdir: {workdir}")
    print("loading dataset…")
    try:
        dataset = StableNeRFDataset(args.dataset, shape=args.image_size,
                                    encoded_shape=args.latent_size,
                                    percent_objects=args.percent_objects,
                                    root=args.data_root, seed=args.seed)
    except NotImplementedError as e:       # the objaverse loader
        sys.exit(f"not ported yet: --dataset {args.dataset}: {e}")
    print(f"dataset: {len(dataset)} paired samples")

    if args.inference:
        run_inference(cfg, dataset, workdir, guidance_scale=args.guidance_scale,
                      save_attn_maps=args.save_attn_maps, device=dev)
        return

    from .training.loop import train

    train(cfg, dataset, workdir=workdir, seed=args.seed, profile_dir=args.profile_dir,
          resume=args.resume, device=dev)


def run_inference(cfg, dataset, workdir, guidance_scale: float = 1.0,
                  save_attn_maps: bool = False, device=None):
    """Restore the latest checkpoint under ``workdir`` and run the DDIM
    novel-view inference on the test split (batches of 2), writing the
    denoised and target views (PNG, or .npy without PIL) and, on request,
    the ip-stream attention maps to ``workdir/renders``."""
    import numpy as np
    import torch

    from .data.dataset import iterate, split_dataset
    from .models.diffusion.scheduler import DDIMScheduler
    from .models.nerf.grid import grid_init
    from .training.checkpoints import (CheckpointManager, frozen_partition_checksum,
                                       verify_frozen_checksum)
    from .training.inference import make_inference_step
    from .training.joint import eval_budget_for_occupancy, joint_trainable_mask
    from .training.loop import build_initial_params
    from .utils.device import resolve_device
    from .utils.tree import partition
    from .utils.visualization import save_image

    dev = resolve_device(device)
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    if ckpt.latest_step() is None:
        sys.exit(f"no checkpoint found under {workdir}/checkpoints")
    fmt = ckpt.read_format()
    t_only = bool(fmt.get("trainable_only"))
    seed = 0
    if t_only:
        # the frozen partition is rebuilt as the training run built it
        if fmt.get("pretrained_sd"):
            sys.exit(f"checkpoint {workdir} was trained WITH --sdxl-checkpoint, "
                     f"which is not ported yet")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, frozen_dtype=fmt.get("frozen_dtype"),
            trainable_scope=fmt.get("trainable_scope", cfg.train.trainable_scope)))
        seed = int(fmt.get("seed", 0))
    params = build_initial_params(cfg, seed, seed + 1, device=dev)
    mask = joint_trainable_mask(params, cfg.train.trainable_scope)
    if t_only:
        verify_frozen_checksum(fmt.get("frozen_checksum"),
                               frozen_partition_checksum(params, mask))
    live = partition(params, mask)[0] if t_only else params
    state = ckpt.restore(template={"trainable" if t_only else "params": live,
                                   "opt_state": None, "extra": None,
                                   "grid_state": grid_init(cfg.nerf, device=dev)})
    grid_state = state["grid_state"]
    del state

    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    occ_frac = float(grid_state.occ.float().mean())
    budget = eval_budget_for_occupancy(occ_frac, 2 * cfg.latent_hw ** 2, cfg.train)
    print(f"eval budget: occ={occ_frac:.4f} → {budget} samples/batch")
    infer = make_inference_step(cfg, scheduler, cfg.train.num_inference_steps,
                                guidance_scale=guidance_scale,
                                capture_attn_maps=save_attn_maps, sample_budget=budget,
                                device=dev)
    _, _, te_idx = split_dataset(len(dataset), seed=cfg.train.seed)

    renders = os.path.join(workdir, "renders")
    os.makedirs(renders, exist_ok=True)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    total_l2 = 0.0
    for i, batch in enumerate(iterate(dataset, te_idx, 2)):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
        out = infer(params, grid_state, batch, generator=generator)
        total_l2 += float(out["l2_loss"])
        psnr = out["psnr"].float().cpu().numpy()
        for j in range(out["denoised_image"].shape[0]):
            print(f"image {i}_{j}: PSNR {float(psnr[j, 0]):.2f} "
                  f"SSIM {float(out['ssim']):.3f} L2 {float(out['l2_loss']):.4f}")
            save_image(os.path.join(renders, f"denoised_{i}_{j}.png"),
                       out["denoised_image"][j], chw=True)
            save_image(os.path.join(renders, f"target_{i}_{j}.png"),
                       out["target_image"][j], chw=True)
        if "ip_attn_maps" in out:
            np.savez(os.path.join(renders, f"ip_attn_maps_{i}.npz"),
                     **{f"layer_{n:03d}": m.float().cpu().numpy()
                        for n, m in enumerate(out["ip_attn_maps"])})
    print(f"Average L2 over test set: {total_l2}")


if __name__ == "__main__":
    main()
