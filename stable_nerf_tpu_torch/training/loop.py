"""The joint Stable-NeRF training loop on one device (counterpart of
stable_nerf_tpu/training/loop.py; reference train.py:110-319).

Per epoch: refresh the occupancy grid, run train steps over the
prefetched train split, validate, run DDIM inference on the test split
every ``inference_every`` epochs, checkpoint.  Beyond the reference, as in
the JAX package: resumable checkpoints with optimizer state, a SIGTERM
stop that saves first, metrics in ``metrics.jsonl``, the occupancy-driven
sample budgets and the stochastic-encode warm-up.

The data-, tensor- and fully-sharded paths of the JAX loop are not ported
yet.  A restore loads on the CPU and copies into the live tensors, then
into the optimizer, so the card never holds the state twice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import iterate, split_dataset
from ..data.prefetch import device_prefetch
from ..models.diffusion.scheduler import DDIMScheduler
from ..models.diffusion.sd_network import init_ip_from_unet, sd_network_init
from ..models.nerf.grid import grid_init, mark_untrained_grid, update_extra_state
from ..models.nerf.network import nerf_density, nerf_init
from ..ops.compaction import suggest_sample_budget
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, device_memory_stats
from ..utils.tree import dealias, partition, tree_leaves
from ..utils.visualization import sample_save_for_vis
from .checkpoints import (CheckpointManager, frozen_partition_checksum,
                          verify_frozen_checksum)
from .inference import make_inference_step
from .joint import (JointConfig, cast_frozen, derive_train_sample_budget,
                    device_hbm_limit, eval_budget_for_occupancy, joint_trainable_mask,
                    make_eval_step, make_lr_scheduler, make_optimizer, make_train_step)

NOT_PORTED_PARALLEL = ("is not ported yet: ROADMAP.md §1 queue, parallel/ "
                       "(DDP, FSDP, tensor and sequence parallelism)")


def _install_sigterm_flag():
    """A SIGTERM handler that only sets a flag, polled by the loop at each
    batch boundary.  Returns ``(flag, uninstall)``; off the main thread,
    where a handler cannot be installed, the flag never sets."""
    flag = {"set": False}

    def handler(signum, frame):
        flag["set"] = True

    try:
        prev = signal.signal(signal.SIGTERM, handler)
    except ValueError:          # not the main interpreter thread
        return flag, lambda: None
    return flag, lambda: signal.signal(signal.SIGTERM, prev)


def _stream_seed(seed: int, start_epoch: int) -> int:
    """Seed of the loop's draws: a resumed run's stream differs from the
    epochs already run (the JAX loop folds the start epoch into its key)."""
    return int(np.random.SeedSequence([seed, start_epoch]).generate_state(1, np.uint64)[0])


def build_initial_params(cfg: JointConfig, seed_sd: int, seed_nerf: int,
                         pretrained_sd: Optional[Dict] = None, *,
                         device: Optional[torch.device] = None) -> Dict:
    """The joint param tree as a fresh run builds it: the seeded random
    init, the IP heads copied from the U-Net's to_k/to_v (reference
    network.py:104-110), the frozen partition stored in
    ``cfg.train.frozen_dtype``.  A trainable-only restore rebuilds the
    frozen partition through this function, so it must stay deterministic
    in its inputs.  Runs on ``device`` (default cuda)."""
    dev = resolve_device(device)
    if pretrained_sd is not None:
        raise NotImplementedError(
            "pretrained SDXL weights are not ported yet: ROADMAP.md §1 queue, "
            "CLIP, the tokenizer and weights.py")
    params = {"sd": init_ip_from_unet(sd_network_init(seed_sd, cfg.sd, device=dev)),
              "nerf": nerf_init(seed_nerf, cfg.nerf, device=dev)}
    mask = joint_trainable_mask(params, cfg.train.trainable_scope)
    params = cast_frozen(params, mask, cfg.train.frozen_dtype)
    # the optimizer updates leaves in place: no two may share memory
    return dealias(params)[0]


def _resolve_ckpt_format(ckpt, cfg, seed, has_pretrained, resume, log_fn,
                         fingerprint=None):
    """This run's checkpoint format, checked against the directory's.

    A directory that holds checkpoints keeps its format.  The frozen
    partition of a trainable-only checkpoint is rebuilt from (seed,
    pretrained weights, frozen_dtype, trainable_scope), recorded in
    FORMAT.json: where such steps exist, a run that differs on any of them
    is refused, whether it resumes from them or would write more.
    Returns (trainable_only, fmt)."""
    want = bool(cfg.train.checkpoint_trainable_only)
    on_disk = ckpt.read_format()
    has_steps = ckpt.latest_step() is not None
    t_only = bool(on_disk.get("trainable_only")) if has_steps else want
    if has_steps and t_only != want:
        log_fn(f"checkpoints: directory already holds "
               f"{'trainable-only' if t_only else 'full-state'} checkpoints "
               f"— continuing in that format")
    if t_only and has_steps:
        expect = {"seed": seed, "pretrained_sd": has_pretrained,
                  "frozen_dtype": cfg.train.frozen_dtype,
                  "trainable_scope": cfg.train.trainable_scope,
                  "sdxl_fingerprint": (fingerprint or {}).get("digest")}
        unrecorded = [k for k in expect if k not in on_disk]
        got = {k: on_disk[k] for k in expect if k in on_disk}
        want_rec = {k: expect[k] for k in got}
        if got != want_rec:
            raise ValueError(
                "trainable-only checkpoint directory refused: the frozen "
                "partition is rebuilt from (seed, --sdxl-checkpoint, "
                f"frozen_dtype), but the checkpoint records {got} while "
                f"this run has {want_rec} — "
                + ("the restored trainables would condition a different "
                   "frozen model" if resume else
                   "new steps written here would be unrestorable against "
                   "the recorded inputs (use a fresh --workdir)"))
        if unrecorded:
            log_fn(f"checkpoints: sidecar predates {unrecorded} — those "
                   f"reconstruction inputs cannot be verified for this directory")
    fmt = None
    if t_only:
        fmt = {"version": 2, "trainable_only": True, "seed": seed,
               "pretrained_sd": has_pretrained,
               "frozen_dtype": cfg.train.frozen_dtype,
               "trainable_scope": cfg.train.trainable_scope,
               "sdxl_fingerprint": (fingerprint or {}).get("digest"),
               "sdxl_checkpoint_path": (fingerprint or {}).get("path")}
    return t_only, fmt


def train(cfg: JointConfig, dataset, *, workdir: str = "output", seed: int = 0,
          epochs: Optional[int] = None, pretrained_sd: Optional[Dict] = None,
          log_fn=print, data_parallel: bool = False, tensor_parallel: int = 1,
          fsdp: bool = False, mesh=None, resume: bool = False,
          profile_dir: Optional[str] = None,
          pretrained_fingerprint: Optional[Dict] = None,
          device: Optional[torch.device] = None):
    """Run joint training on ``device`` (default cuda; raises without a
    card); returns (params, grid_state, metrics_history).

    ``dataset``: anything with ``__len__``, ``__getitem__`` (a dict of
    numpy arrays), ``intrinsic`` and ``all_poses()``, as
    ``data.dataset.StableNeRFDataset``.

    ``resume``: restore the latest checkpoint under ``workdir`` (params,
    optimizer and lr schedule, occupancy grid, epoch) and continue from
    the recorded epoch.  SIGTERM stops the loop at the next batch boundary
    after a resumable checkpoint is saved.  ``profile_dir``: a
    ``torch.profiler`` trace of steps 1-4 of the first epoch run, written
    there as ``trace.json``."""
    if data_parallel or tensor_parallel > 1 or fsdp or mesh is not None:
        raise NotImplementedError("multi-device training " + NOT_PORTED_PARALLEL)
    dev = resolve_device(device)
    preempt_flag, uninstall = _install_sigterm_flag()
    try:
        return _train_impl(cfg, dataset, workdir=workdir, seed=seed, epochs=epochs,
                           pretrained_sd=pretrained_sd, log_fn=log_fn, resume=resume,
                           profile_dir=profile_dir, preempt_flag=preempt_flag,
                           pretrained_fingerprint=pretrained_fingerprint, dev=dev)
    finally:
        uninstall()


def _train_impl(cfg: JointConfig, dataset, *, workdir: str, seed: int,
                epochs: Optional[int], pretrained_sd: Optional[Dict], log_fn,
                resume: bool, profile_dir: Optional[str], preempt_flag: Dict,
                pretrained_fingerprint: Optional[Dict], dev: torch.device):
    os.makedirs(workdir, exist_ok=True)

    def log_hbm(stage):
        """STABLE_NERF_LOG_HBM=1: the device's memory after each set-up stage."""
        if os.environ.get("STABLE_NERF_LOG_HBM") != "1":
            return
        for name, s in device_memory_stats().items():
            log_fn(f"hbm[{stage}] {name}: in_use={s['bytes_in_use'] / 2 ** 30:.2f} GB "
                   f"peak={s['peak_bytes_in_use'] / 2 ** 30:.2f} GB "
                   f"limit={s['bytes_limit'] / 2 ** 30:.2f} GB")

    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    had_pretrained = pretrained_sd is not None
    params = build_initial_params(cfg, seed, seed + 1, pretrained_sd, device=dev)
    log_hbm("params-init")

    grid_state = mark_untrained_grid(
        grid_init(cfg.nerf, device=dev),
        torch.as_tensor(dataset.all_poses(), dtype=torch.float32, device=dev),
        dataset.intrinsic, cfg.nerf)
    trainable_share = float((grid_state.density_grid >= 0).float().mean())
    log_fn(f"grid: {trainable_share:.4f} of the cells seen by a camera")

    mask = joint_trainable_mask(params, cfg.train.trainable_scope)
    optimizer = make_optimizer(cfg.train, params, mask)
    lr_scheduler = make_lr_scheduler(cfg.train, optimizer)

    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    t_only, ckpt_fmt = _resolve_ckpt_format(ckpt, cfg, seed, had_pretrained, resume,
                                            log_fn, fingerprint=pretrained_fingerprint)
    if t_only:
        # the trainable-only format rebuilds the frozen partition on
        # restore: a checksum of it travels in FORMAT.json
        fsum = frozen_partition_checksum(params, mask)
        if resume and ckpt.latest_step() is not None:
            verify_frozen_checksum(ckpt.read_format().get("frozen_checksum"), fsum,
                                   log_fn=log_fn)
            log_fn("checkpoints: frozen checksum verified")
        ckpt_fmt["frozen_checksum"] = fsum

    def save_ckpt(step_num: int, wait: bool = False):
        p, pk = params, "params"
        if t_only:
            p, _ = partition(p, mask)
            pk = "trainable"
        t0 = time.perf_counter()
        opt_state = {"optimizer": optimizer.state_dict(),
                     "lr_scheduler": lr_scheduler.state_dict()}
        if ckpt.save(step_num, p, opt_state, grid_state, extra={"epoch": step_num},
                     wait=wait, params_key=pk, fmt=ckpt_fmt):
            size = os.path.getsize(os.path.join(ckpt.directory, f"{step_num}.pt"))
            log_fn(f"checkpoint step {step_num} saved: {size} bytes in "
                   f"{time.perf_counter() - t0:.3f} s")

    start_epoch = 0
    if resume:
        if ckpt.latest_step() is None:
            log_fn(f"WARNING: resume requested but no checkpoint found under "
                   f"{workdir}/checkpoints — starting from scratch")
        else:
            t0 = time.perf_counter()
            pk = "trainable" if t_only else "params"
            live = partition(params, mask)[0] if t_only else params
            state = ckpt.restore(template={pk: live, "opt_state": None,
                                           "grid_state": grid_state, "extra": None})
            grid_state = state["grid_state"]
            optimizer.load_state_dict(state["opt_state"]["optimizer"])
            lr_scheduler.load_state_dict(state["opt_state"]["lr_scheduler"])
            start_epoch = int(state["extra"].get("epoch", 0))
            del state
            log_fn(f"resumed from checkpoint step {ckpt.latest_step()} "
                   f"(epoch {start_epoch}" + (", trainable-only format)" if t_only
                                              else ")")
                   + f" in {time.perf_counter() - t0:.3f} s")
        log_hbm("restore")

    step_cache = {}
    with_vis = cfg.train.vis_sample_prob > 0

    def step_for_budget(budget, stochastic=False):
        """One train step per (sample budget, encode mode)."""
        if (budget, stochastic) not in step_cache:
            step_cfg = cfg
            if cfg.train.stochastic_until_epoch:
                # the schedule decides the encode mode outright
                step_cfg = dataclasses.replace(cfg, nerf=dataclasses.replace(
                    cfg.nerf, hash_stochastic=stochastic))
            step_cache[(budget, stochastic)] = make_train_step(
                step_cfg, scheduler, optimizer, lr_scheduler=lr_scheduler,
                sample_budget=budget, with_vis=with_vis, device=dev)
        return step_cache[(budget, stochastic)]

    batch_size = cfg.train.batch_size
    cur_budget = cfg.train.sample_budget
    if cur_budget is None and not cfg.train.sample_budget_auto:
        # no budget given: dense unless the step would not fit the card
        limit = device_hbm_limit(dev)
        if limit:
            nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs
                                    if isinstance(x, torch.Tensor))
            trainable = [x for x in tree_leaves(partition(params, mask)[0])
                         if isinstance(x, torch.Tensor) and x.is_floating_point()]
            # AdamW holds two float32 moments a trainable leaf
            state_bytes = (nbytes(tree_leaves(params)) + 2 * nbytes(trainable)
                           + nbytes(grid_state))
            cur_budget = derive_train_sample_budget(
                2 * batch_size * cfg.latent_hw ** 2, cfg.train.max_steps_train,
                state_bytes, limit)
            if cur_budget is not None:
                log_fn(f"sample budget: derived {cur_budget} from the device memory "
                       f"(state {state_bytes / 2 ** 30:.1f} GB, limit "
                       f"{limit / 2 ** 30:.1f} GB) — the dense lattice would not "
                       f"fit; override with --sample-budget")

    eval_cache, infer_cache = {}, {}

    def eval_for_budget(budget):
        if budget not in eval_cache:
            eval_cache[budget] = make_eval_step(cfg, scheduler, sample_budget=budget,
                                                device=dev)
        return eval_cache[budget]

    def infer_for_budget(budget):
        if budget not in infer_cache:
            infer_cache[budget] = make_inference_step(
                cfg, scheduler, cfg.train.num_inference_steps, sample_budget=budget,
                device=dev)
        return infer_cache[budget]

    def density_fn(x):
        return nerf_density(params["nerf"], x, cfg.nerf)["sigma"] * cfg.nerf.density_scale

    def to_device(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tr_idx, va_idx, te_idx = split_dataset(len(dataset), 0.8, 0.1, seed=seed)
    epochs = epochs if epochs is not None else cfg.train.epochs
    history = []
    timer = StepTimer()
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    # host RNG of the vis dumps, apart from the training draws
    vis_rng = random.Random(seed + 17)
    generator = torch.Generator(device=dev).manual_seed(_stream_seed(seed, start_epoch))
    rays_per_step = 2 * batch_size * cfg.latent_hw ** 2
    preempted = False
    t_loop0 = time.perf_counter()

    for epoch in range(start_epoch, epochs):
        sync()
        t0 = time.perf_counter()
        grid_state = update_extra_state(grid_state, density_fn, cfg.nerf,
                                        generator=generator)
        # one host read a refresh: it sets the train and eval budgets
        occ_frac = float(grid_state.occ.float().mean())
        log_fn(f"epoch {epoch}: grid refresh {(time.perf_counter() - t0) * 1e3:.1f} ms, "
               f"occupied {occ_frac:.6f}")
        if cfg.train.sample_budget_auto:
            cur_budget = suggest_sample_budget(occ_frac, rays_per_step,
                                               cfg.train.max_steps_train)
        warm = epoch < cfg.train.stochastic_until_epoch
        if cfg.train.stochastic_until_epoch and epoch == cfg.train.stochastic_until_epoch:
            log_fn(f"epoch {epoch}: stochastic warmup over — switching to the exact "
                   f"8-corner encode")
        step_fn = step_for_budget(cur_budget, warm)

        train_metrics = []
        profiler = None
        t_train0 = time.perf_counter()
        for i, batch in enumerate(device_prefetch(
                iterate(dataset, tr_idx, batch_size, shuffle=True, seed=seed + epoch),
                device=dev)):
            if preempt_flag["set"]:
                preempted = True
                break
            # trace a few steady steps of the first epoch run (step 0 warms up)
            if profile_dir and epoch == start_epoch:
                if i == 1:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                    log_fn(f"profiler: tracing steps 1-4 to {profile_dir}")
                elif i == 5 and profiler is not None:
                    sync()
                    profiler.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                    profiler = None
            out = step_fn(params, grid_state, batch, generator=generator)
            if with_vis:
                m, vis = out
                # an independent draw a tensor; a copy only when sampled
                for prefix, tensor in vis.items():
                    sample_save_for_vis(prefix, tensor, cfg.train.vis_sample_prob,
                                        directory=os.path.join(workdir, "visualizations"),
                                        rng=vis_rng)
            else:
                m = out
            train_metrics.append(m)
        # the steps return before the card finishes them: wait before the clock
        sync()
        train_wall = time.perf_counter() - t_train0
        timer.observe(steps=len(train_metrics),
                      rays=rays_per_step * len(train_metrics), seconds=train_wall)
        if profiler is not None:        # an epoch shorter than the trace window
            sync()
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

        if preempted:
            # the epoch is incomplete and re-runs on --resume
            latest = ckpt.latest_step()
            if latest is None or latest < epoch:
                save_ckpt(epoch, wait=True)
                log_fn(f"preempted (SIGTERM): resumable checkpoint saved; "
                       f"epoch {epoch} re-runs on --resume")
            else:
                log_fn(f"preempted (SIGTERM): checkpoint step {latest} "
                       f"committed; exiting cleanly")
            break

        val_metrics = []
        if cfg.train.val_every > 0 and (epoch % cfg.train.val_every == 0
                                        or epoch == epochs - 1):
            # validation renders target + reference: 2B views
            t0 = time.perf_counter()
            eval_fn = eval_for_budget(eval_budget_for_occupancy(
                occ_frac, 2 * batch_size * cfg.latent_hw ** 2, cfg.train))
            for batch in iterate(dataset, va_idx, batch_size):
                val_metrics.append(eval_fn(params, grid_state, to_device(batch),
                                           generator=generator))
            sync()
            log_fn(f"epoch {epoch}: validation {len(val_metrics)} batches in "
                   f"{time.perf_counter() - t0:.3f} s")

        def epoch_means(ms):
            """Means of each metric, read from the card once."""
            if not ms:
                return {}
            keys = list(ms[0])
            means = torch.stack([torch.stack([m[k].float() for k in keys])
                                 for m in ms]).mean(dim=0).tolist()
            return dict(zip(keys, means))

        tr_mean = epoch_means(train_metrics)
        va_mean = epoch_means(val_metrics)
        nan = float("nan")
        epoch_rays = rays_per_step * len(train_metrics)
        record = {
            "epoch": epoch,
            "train_loss": tr_mean.get("loss", nan),
            "train_sd_loss": tr_mean.get("sd_loss", nan),
            "train_nerf_loss": tr_mean.get("nerf_loss", nan),
            "val_loss": va_mean.get("loss", nan),
            "val_sd_loss": va_mean.get("sd_loss", nan),
            "val_nerf_loss": va_mean.get("nerf_loss", nan),
            "rays_per_sec": epoch_rays / train_wall if train_wall > 0 else nan,
            "rays_per_sec_cum": timer.rays_per_sec(),
            "steps_per_sec": len(train_metrics) / train_wall if train_wall > 0 else nan,
            "train_wall_s": round(train_wall, 1),
            "elapsed_s": round(time.perf_counter() - t_loop0, 1),
        }
        history.append(record)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        log_fn(f"epoch {epoch}: train {record['train_loss']:.4f} "
               f"val {record['val_loss']:.4f} ({record['rays_per_sec']:.0f} rays/s, "
               f"{len(train_metrics)} steps in {train_wall:.3f} s)")

        if (cfg.train.inference_every > 0 and (epoch + 1) % cfg.train.inference_every == 0
                and len(te_idx) > 0):
            # inference renders the 2 target views of a batch
            t0 = time.perf_counter()
            infer_fn = infer_for_budget(eval_budget_for_occupancy(
                occ_frac, 2 * cfg.latent_hw ** 2, cfg.train))
            inf_metrics = []
            for i, batch in enumerate(iterate(dataset, te_idx, 2)):
                out = infer_fn(params, grid_state, to_device(batch), generator=generator)
                inf_metrics.append({
                    "psnr": float(out["psnr"].float().mean()),
                    "latent_psnr": float(out["latent_psnr"].float().mean()),
                    "ssim": float(out["ssim"]),
                    "l2_loss": float(out["l2_loss"]),
                })
                log_fn(f"  inference[{i}]: psnr={inf_metrics[-1]['psnr']:.2f} "
                       f"latent_psnr={inf_metrics[-1]['latent_psnr']:.2f} "
                       f"ssim={inf_metrics[-1]['ssim']:.3f} "
                       f"l2={inf_metrics[-1]['l2_loss']:.4f}")
            log_fn(f"epoch {epoch}: inference {len(inf_metrics)} requests in "
                   f"{time.perf_counter() - t0:.3f} s")
            if inf_metrics:
                inf_record = {"epoch": epoch, "kind": "inference"}
                for k in inf_metrics[0]:
                    inf_record[f"inference_{k}"] = float(np.mean([m[k] for m in inf_metrics]))
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(inf_record) + "\n")

        if cfg.train.checkpoint_every > 0 and (epoch + 1) % cfg.train.checkpoint_every == 0:
            save_ckpt(epoch + 1)

    if epochs > start_epoch and not preempted:
        # not when no epoch ran: a resume with nothing left to do must not
        # rewrite the checkpoint it restored
        save_ckpt(epochs, wait=True)
    ckpt.wait_until_finished()
    return params, grid_state, history
