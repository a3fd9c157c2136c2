"""Joint Stable-NeRF training and inference driver of the PyTorch port
(counterpart of the repository's train.py, with the same flags and one
more, ``--device``).

Usage:
  python -m stable_nerf_tpu_torch.train --dataset synthetic     # train
  python -m stable_nerf_tpu_torch.train --sdxl-checkpoint DIR   # objaverse, real SDXL
  python -m stable_nerf_tpu_torch.train --dataset synthetic --demo \\
      --vae-checkpoint runs/demo_vae/vae.npz                     # learned-diffusion demo
  python -m stable_nerf_tpu_torch.train --inference --workdir X # restore + DDIM
  python -m stable_nerf_tpu_torch.train --tiny --dataset synthetic \\
      --image-size 32 --latent-size 16 --device cpu              # smoke run
  python -m stable_nerf_tpu_torch.train --data-parallel [--fsdp]  # one process a card
  torchrun --nproc-per-node N -m stable_nerf_tpu_torch.train --distributed [--fsdp]
  python -m stable_nerf_tpu_torch.train --data-parallel --coordinator HOST:PORT \\
      --num-processes N --process-id I                           # each process
  python -m stable_nerf_tpu_torch.train --tensor-parallel 2 ...  # (data x model) mesh
  python -m stable_nerf_tpu_torch.train --inference --tensor-parallel T --sp S ...
                                                    # serving sharded over T·S processes
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Optional

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
                   help="SDXL checkpoint dir (HF hub layout: unet/, vae/, text_encoder/, "
                        "text_encoder_2/ with safetensors or bin files)")
    p.add_argument("--sample-budget", default=None,
                   help="NeRF sample budget per step: an int (static), 'auto' "
                        "(re-bucketed at each occupancy refresh), or omitted for "
                        "dense unless the card's memory needs less")
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallel over every visible card: one process a card "
                        "(started here unless a launcher or --coordinator started "
                        "this one), gradients averaged before each update")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="model-axis size: the U-Net's heads and GEGLU width split over "
                        "this many processes (training on a (data x model) mesh of the "
                        "world; with --inference, serving, with --sp); SDXL admits 2, 5, "
                        "10"),
    p.add_argument("--fsdp", action="store_true",
                   help="fully-shard the SD params + AdamW moments over the data-parallel "
                        "processes (ZeRO-3: gathered for use, gradients reduce-scattered)")
    p.add_argument("--frozen-bf16", action="store_true",
                   help="store the frozen partition (SDXL U-Net base + VAE) in "
                        "bfloat16 (must match across --resume)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the U-Net's resnet and transformer blocks on the "
                        "backward (torch.utils.checkpoint): ~33%% more U-Net FLOPs for "
                        "less activation memory")
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
                   help="with --inference: sequence-parallel axis size (ring attention "
                        "over the latent tokens); composes with --tensor-parallel on a "
                        "(data x seq x model) mesh")
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
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and train data parallel")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of rank 0's store for a process group started by "
                        "hand (pair with --num-processes/--process-id); implies "
                        "--distributed")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (smoke tests; pairs with --image-size "
                        "32 --latent-size 16)")
    p.add_argument("--demo", action="store_true",
                   help="learned-diffusion demo preset: the demo U-Net trained from "
                        "scratch (--trainable-scope sd), a scene-pretrained tiny VAE "
                        "(--vae-checkpoint), geometric ray intrinsics, image 64 / "
                        "latent 16 unless given")
    p.add_argument("--trainable-scope", default=None, choices=("reference", "sd"),
                   help="optimizer coverage: 'reference' = ip heads + NeRF (default); "
                        "'sd' = also the whole U-Net")
    p.add_argument("--vae-checkpoint", default=None,
                   help="a pretrained tiny VAE (.npz, scripts/pretrain_tiny_vae.py or "
                        "scripts/pretrain_torch_tiny_vae.py): overlays its params and "
                        "adopts its config, measured latent scaling factor included")
    p.add_argument("--vae-encode", default=None, choices=("sample", "mode"),
                   help="latent-target encode: 'sample' (reference parity) or 'mode'")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port runs (default cuda; raises without a card)")
    return p


def _default_workdir() -> str:
    from datetime import datetime

    return f"output_{datetime.now().strftime('%Y%m%d_%H%M%S')}"


def free_port() -> int:
    """A free TCP port on this host, for a local process group's store."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(argv, n: int, command=None, timeout: Optional[float] = None) -> int:
    """Run ``n`` processes of ``command`` (default this module) with
    ``argv`` and ``--coordinator localhost:PORT --num-processes n
    --process-id i``, one a card; wait for all and return the first
    non-zero exit code (0 when all succeed).  A failure, an interrupt or
    ``timeout`` seconds (then TimeoutError) stops the others: no process
    outlives this call."""
    import subprocess

    command = command or [sys.executable, "-m", "stable_nerf_tpu_torch.train"]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    # the processes share the host's cores (as torchrun sets it)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    coordinator = f"localhost:{free_port()}"
    procs = [subprocess.Popen([*command, *argv, "--coordinator", coordinator,
                               "--num-processes", str(n), "--process-id", str(i)], env=env)
             for i in range(n)]
    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} processes of {command} still ran after "
                                   f"{timeout} s")
            time.sleep(0.2)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def join_process_group(args):
    """The world of this process under ``--distributed`` or ``--coordinator``
    (its rank's card, NCCL on cards, gloo with ``--device cpu``): a
    (data × seq × model) mesh to serve with ``--inference`` and
    ``--tensor-parallel``/``--sp``, a (data × model) mesh to train with
    ``--tensor-parallel``, else a data-parallel one; None when neither flag
    is given."""
    if not (args.distributed or args.coordinator):
        return None
    import torch

    from .parallel.sharding import make_mesh, make_mesh_2d, make_mesh_3d

    if args.coordinator:
        rank, world = args.process_id, args.num_processes
        init, local = f"tcp://{args.coordinator}", args.process_id
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init, local = "env://", int(os.environ.get("LOCAL_RANK", rank))
    device = args.device
    if device == "cuda":
        from .utils.device import resolve_device

        resolve_device(device)              # no card: raise, never fall back
        device = f"cuda:{local % torch.cuda.device_count()}"
    kw = dict(init_method=init, rank=rank, world_size=world)
    if args.inference:
        mesh = make_mesh_3d(device, sp=args.sp, tp=args.tensor_parallel, **kw)
    elif args.tensor_parallel > 1:
        mesh = make_mesh_2d(device, tp=args.tensor_parallel, **kw)
    else:
        mesh = make_mesh(device, **kw)
    print(f"distributed: process {mesh.rank}/{mesh.world} on {mesh.device} over "
          f"{mesh.backend}, mesh {mesh.shape}")
    return mesh


def apply_demo_defaults(args) -> None:
    """The --demo preset's defaults, where the flags keep train.py's own:
    image 64, latent 16, trainable scope "sd", the mode encode."""
    if args.image_size == 512:
        args.image_size = 64
    if args.latent_size == 64:
        args.latent_size = 16
    if args.trainable_scope is None:
        args.trainable_scope = "sd"
    if args.vae_encode is None:
        args.vae_encode = "mode"


def check_vae_artifact(args, meta) -> None:
    """Refuse an artifact trained at other sizes than the run's."""
    if meta.get("latent_size") not in (None, args.latent_size):
        sys.exit(f"--vae-checkpoint was trained at latent {meta['latent_size']}, "
                 f"run wants {args.latent_size}")
    if meta.get("image_size") not in (None, args.image_size):
        sys.exit(f"--vae-checkpoint was trained at image {meta['image_size']}, "
                 f"run wants {args.image_size}")


def demo_vae_config(image_size: int, latent_size: int):
    """The tiny VAE without an artifact, as the pretraining script builds
    it: for image = latent·2^k, k + 1 stages of widths 32·2^i."""
    from .models.diffusion.vae import VAEConfig

    factor = image_size // latent_size
    if factor * latent_size != image_size or 2 ** (factor.bit_length() - 1) != factor:
        sys.exit("--demo needs image-size = latent-size x 2^k")
    return VAEConfig(block_out_channels=tuple(32 * 2 ** i for i in range(factor.bit_length())),
                     layers_per_block=1, norm_groups=8)


def latent_background(vae_params, cfg, device) -> tuple:
    """The per-channel latent of a white image, in the supervised space
    ((mode latent + 1) / 2, averaged over the latent's pixels): the NeRF's
    background colour under a trained VAE, whose white is no latent 1."""
    import torch

    from .models.diffusion.sd_network import encode_images_mode

    white = torch.ones((1, 3, cfg.sd.sd.image_size, cfg.sd.sd.image_size), device=device)
    with torch.no_grad():
        lt = encode_images_mode({"vae": vae_params}, white, cfg.sd)
    return tuple(float(v) for v in (lt.mean(dim=(0, 2, 3)) + 1.0) / 2.0)


def build_config(args, vae_cfg=None):
    """The JointConfig that train.py builds from the same flags: the
    flagship, the --tiny or the --demo preset (``apply_demo_defaults``
    already applied; ``vae_cfg`` the artifact's, else derived from the
    sizes)."""
    from .config import HashGridConfig, NeRFConfig, SDConfig, TrainConfig
    from .models.diffusion.sd_network import SDNetworkConfig
    from .models.diffusion.unet import demo_unet_config, tiny_unet_config
    from .models.diffusion.vae import VAEConfig
    from .training.joint import JointConfig

    if args.demo:
        num_tokens = 16
        nerf_cfg = NeRFConfig(channel_dim=4, density_activation="trunc_exp")
        sd_cfg = SDNetworkConfig(
            sd=SDConfig(latent_size=args.latent_size, image_size=args.image_size,
                        cross_attention_dim=64, num_tokens=num_tokens,
                        use_downsampling_layers=False),
            unet=demo_unet_config(num_tokens),
            vae=vae_cfg or demo_vae_config(args.image_size, args.latent_size))
    elif args.tiny:
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
    if args.remat:
        sd_cfg = dataclasses.replace(sd_cfg, unet=dataclasses.replace(sd_cfg.unet,
                                                                      remat=True))
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

    if args.sp > 1 and not args.inference:
        sys.exit("--sp is a serving lever (use with --inference); training "
                 "scale-out is --data-parallel / --tensor-parallel / --fsdp")
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        sys.exit("--coordinator requires --num-processes and --process-id")
    # sharded: the U-Net split over processes, which all take part
    sharded = args.tensor_parallel > 1 or args.sp > 1
    parallel = args.data_parallel or args.fsdp or args.tensor_parallel > 1
    n = 1
    if (sharded or parallel and not args.inference) and not (args.distributed
                                                             or args.coordinator):
        # as the JAX CLI takes every local chip: one process a visible
        # card, a world of one on a single card or the CPU
        import torch

        from .utils.device import resolve_device

        n = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1
    if sharded:
        world = (args.num_processes if args.coordinator
                 else int(os.environ.get("WORLD_SIZE", 1)) if args.distributed else n)
        need = args.tensor_parallel * (args.sp if args.inference else 1)
        if world < need or world % need:
            sys.exit(f"--tensor-parallel {args.tensor_parallel} --sp {args.sp} needs "
                     f"{need} processes (or a multiple), have {world}")
    if n > 1:
        argv = list(argv if argv is not None else sys.argv[1:])
        if not args.workdir:
            argv += ["--workdir", _default_workdir()]
        rc = launch_local(argv, n)
        if rc:
            sys.exit(rc)
        return None
    if args.tiny and args.demo:
        sys.exit("--tiny and --demo are distinct presets — pick one")
    if args.vae_checkpoint and not args.demo:
        sys.exit("--vae-checkpoint is the demo VAE overlay — pair it with "
                 "--demo (whose VAEConfig is adopted from the artifact)")
    if args.compile_cache is not None:
        print("--compile-cache belongs to the JAX package; ignored")
    if args.stochastic and args.stochastic_until_epoch:
        sys.exit("--stochastic (one-corner encode throughout) and "
                 "--stochastic-until-epoch (warmup schedule, exact finish) are "
                 "mutually exclusive — pick one")
    if args.resume and not args.workdir:
        sys.exit("--resume requires --workdir (the run directory whose checkpoints "
                 "to continue from)")
    if (args.distributed or args.coordinator) and not (args.workdir or args.inference):
        sys.exit("--distributed and --coordinator need --workdir: every process "
                 "writes to one directory")
    if args.distributed and not args.coordinator and not args.inference and not all(
            k in os.environ for k in ("RANK", "WORLD_SIZE")):
        sys.exit("--distributed reads torchrun's RANK and WORLD_SIZE: start the "
                 "processes with torchrun, or give --coordinator")
    from .parallel.sharding import close_mesh

    mesh = join_process_group(args) if sharded or not args.inference else None
    try:
        return _run(args, mesh)
    finally:
        if mesh is not None:
            close_mesh()


def _run(args, mesh):
    """main() after the flags are checked: data, weights, then training or
    inference; ``mesh`` is the process group this process joined, if any."""
    from .data.dataset import StableNeRFDataset
    from .utils.device import disable_tf32, resolve_device

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    disable_tf32()
    workdir = args.workdir or _default_workdir()
    vae_overlay = vae_cfg = None
    if args.demo:
        apply_demo_defaults(args)
        if args.vae_checkpoint:
            from .models.diffusion.vae import vae_load_npz

            vae_overlay, vae_cfg, vae_meta = vae_load_npz(args.vae_checkpoint, device=dev)
            check_vae_artifact(args, vae_meta)
            print(f"VAE checkpoint: recon "
                  f"{vae_meta.get('recon_psnr_test', float('nan')):.2f} dB test, "
                  f"scaling {vae_cfg.scaling_factor:.3f}")
    cfg = build_config(args, vae_cfg)
    if vae_overlay is not None:
        # with a scalar background of 1 the NeRF would have to fog empty
        # space to paint the trained VAE's latent of white
        bg = latent_background(vae_overlay, cfg, dev)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bg_color=bg))
        print(f"latent background from VAE(white): {[round(b, 3) for b in bg]}")

    print(f"workdir: {workdir}")
    print("loading dataset…")
    t0 = time.perf_counter()
    dataset = StableNeRFDataset(args.dataset, shape=args.image_size,
                                encoded_shape=args.latent_size,
                                percent_objects=args.percent_objects,
                                root=args.data_root, seed=args.seed,
                                scale_intrinsics=args.demo)
    print(f"dataset: {len(dataset)} paired samples in {time.perf_counter() - t0:.3f} s")

    pretrained = fingerprint = None
    if args.sdxl_checkpoint:
        from .models.diffusion.weights import (checkpoint_fingerprint, load_sdxl,
                                               precheck_sdxl_checkpoint)

        # the checkpoint's key/shape headers against the converters' exact
        # expectations, before any tensor is read
        has_ip = precheck_sdxl_checkpoint(args.sdxl_checkpoint, cfg.sd.unet, cfg.sd.vae)
        # content identity recorded in FORMAT.json: trainable-only
        # checkpoints rebuild the frozen partition from this directory
        fingerprint = checkpoint_fingerprint(args.sdxl_checkpoint)
        print(f"loading SDXL weights from {args.sdxl_checkpoint} "
              f"(digest {fingerprint['digest'][:12]}…)")
        t0 = time.perf_counter()
        # host memory: build_initial_params copies the leaves to the card
        # one at a time, and clones the IP heads there from to_k/to_v, so
        # none are cloned here
        pretrained = load_sdxl(args.sdxl_checkpoint, with_ip=has_ip, unet_cfg=cfg.sd.unet,
                               vae_cfg=cfg.sd.vae, device="cpu")
        print(f"loaded {fingerprint['total_bytes']} bytes of SDXL weights in "
              f"{time.perf_counter() - t0:.3f} s")
    if vae_overlay is not None:
        # the trained VAE replaces the init's through the same overlay as
        # SDXL weights; a trainable-only checkpoint records no fingerprint
        # of it, and its frozen checksum refuses another VAE on restore
        pretrained = {**(pretrained or {}), "vae": vae_overlay}

    if args.inference:
        rank = (args.process_id if args.coordinator
                else int(os.environ.get("RANK", 0)) if args.distributed else 0)
        if rank and mesh is None:
            print(f"process {rank}: --inference runs on process 0 alone")
            return None
        run_inference(cfg, dataset, workdir, guidance_scale=args.guidance_scale,
                      save_attn_maps=args.save_attn_maps, pretrained=pretrained,
                      fingerprint=fingerprint, device=dev, mesh=mesh,
                      tp=args.tensor_parallel, sp=args.sp)
        return None

    from .training.loop import train

    # processes that joined a group train together: data parallel, under
    # --tensor-parallel on a (data x model) mesh
    return train(cfg, dataset, workdir=workdir, seed=args.seed,
                 profile_dir=args.profile_dir, resume=args.resume,
                 pretrained_sd=pretrained, pretrained_fingerprint=fingerprint,
                 device=dev, data_parallel=args.data_parallel or args.fsdp,
                 tensor_parallel=args.tensor_parallel, fsdp=args.fsdp, mesh=mesh)


def run_inference(cfg, dataset, workdir, guidance_scale: float = 1.0,
                  save_attn_maps: bool = False, pretrained=None, fingerprint=None,
                  device=None, mesh=None, tp: int = 1, sp: int = 1):
    """Restore the latest checkpoint under ``workdir`` and run the DDIM
    novel-view inference on the test split (batches of 2), writing the
    denoised and target views (PNG, or .npy without PIL) and, on request,
    the ip-stream attention maps to ``workdir/renders``.

    ``mesh`` (``parallel.make_mesh_3d(sp=sp, tp=tp)``'s, with tp or sp > 1):
    every rank restores and serves with the U-Net sharded
    (``training.inference.make_sharded_inference_step``), drawing the same
    noise; rank 0 writes.

    A trainable-only checkpoint rebuilds its frozen partition from
    ``pretrained`` (``load_sdxl``'s dict) and is refused when it was
    trained with another ``--sdxl-checkpoint`` (``fingerprint``), or with
    one where this run has none, or the other way round."""
    import numpy as np
    import torch

    from .data.dataset import iterate, split_dataset
    from .models.diffusion.scheduler import DDIMScheduler
    from .models.nerf.grid import grid_init
    from .training.checkpoints import (CheckpointManager, frozen_partition_checksum,
                                       verify_frozen_checksum)
    from .training.inference import make_inference_step, make_sharded_inference_step
    from .training.joint import eval_budget_for_occupancy, joint_trainable_mask
    from .training.loop import build_initial_params
    from .utils.device import resolve_device
    from .utils.tree import partition
    from .utils.visualization import save_image

    dev = mesh.device if mesh is not None else resolve_device(device)
    rank0 = mesh is None or mesh.rank == 0
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    if ckpt.latest_step() is None:
        sys.exit(f"no checkpoint found under {workdir}/checkpoints")
    fmt = ckpt.read_format()
    t_only = bool(fmt.get("trainable_only"))
    seed = 0
    if t_only:
        # the frozen partition is rebuilt as the training run built it
        if bool(fmt.get("pretrained_sd")) != (pretrained is not None):
            sys.exit(
                f"checkpoint {workdir} was trained "
                f"{'WITH' if fmt.get('pretrained_sd') else 'WITHOUT'} "
                f"--sdxl-checkpoint; pass the matching flag so the frozen "
                f"partition can be reconstructed")
        if "sdxl_fingerprint" in fmt and fmt["sdxl_fingerprint"] != (
                (fingerprint or {}).get("digest")):
            sys.exit(
                f"checkpoint {workdir} was trained against SDXL checkpoint "
                f"digest {fmt['sdxl_fingerprint']} "
                f"(path {fmt.get('sdxl_checkpoint_path')}); this run's "
                f"--sdxl-checkpoint has digest "
                f"{(fingerprint or {}).get('digest')} — the frozen "
                f"partition would be rebuilt from the wrong file")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, frozen_dtype=fmt.get("frozen_dtype"),
            trainable_scope=fmt.get("trainable_scope", cfg.train.trainable_scope)))
        seed = int(fmt.get("seed", 0))
    # a full-state checkpoint overwrites every leaf: the random init is
    # only its template
    params = build_initial_params(cfg, seed, seed + 1, pretrained if t_only else None,
                                  device=dev)
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
    if tp > 1 or sp > 1:
        print(f"serving sharded: seq={sp} model={tp}")
        build = make_sharded_inference_step(
            cfg, scheduler, cfg.train.num_inference_steps, mesh=mesh, tp=tp, sp=sp,
            guidance_scale=guidance_scale, capture_attn_maps=save_attn_maps,
            sample_budget=budget)
        params, infer = build(params)
    else:
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
        if not rank0:
            continue
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
    if rank0:
        print(f"Average L2 over test set: {total_l2}")


if __name__ == "__main__":
    main()
