"""The joint Stable-NeRF training loop (counterpart of
stable_nerf_tpu/training/loop.py; reference train.py:110-319), on one
device or as one rank of a data-parallel or fully-sharded world.

Per epoch: refresh the occupancy grid, run train steps over the
prefetched train split, validate, run DDIM inference on the test split
every ``inference_every`` epochs, checkpoint.  Beyond the reference, as in
the JAX package: resumable checkpoints with optimizer state, a SIGTERM
stop that saves first, metrics in ``metrics.jsonl``, the occupancy-driven
sample budgets and the stochastic-encode warm-up.

Pretrained SDXL weights (``models.diffusion.weights.load_sdxl``) overlay
the random init leaf by leaf in ``build_initial_params``.  A restore loads
on the CPU and copies into the live tensors, then into the optimizer, so
the card never holds the state twice.  As one rank of a (data × model)
mesh the U-Net trains tensor-parallel (``parallel.tp``), alone or under
FSDP.
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
import torch.distributed as dist

from ..data.dataset import iterate, split_dataset
from ..data.prefetch import device_prefetch
from ..models.diffusion.clip_text import make_empty_prompt_conditioning
from ..models.diffusion.scheduler import DDIMScheduler
from ..models.diffusion.sd_network import init_ip_from_unet, sd_network_init
from ..models.nerf.grid import grid_init, mark_untrained_grid, update_extra_state
from ..models.nerf.network import nerf_density, nerf_init
from ..ops.compaction import suggest_sample_budget
from ..parallel.fsdp import place_joint_for_fsdp
from ..parallel.sharding import (barrier, close_mesh, make_mesh, make_mesh_2d,
                                 make_parallel_train_step, process_shard_indices, replicate)
from ..parallel.tp import place_joint_for_tp
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, device_memory_stats
from ..utils.tree import dealias, partition, tree_leaves, tree_map
from ..utils.visualization import sample_save_for_vis
from .checkpoints import (CheckpointManager, copy_into, frozen_partition_checksum,
                          verify_frozen_checksum)
from .inference import make_inference_step
from .joint import (JointConfig, cast_frozen, derive_train_sample_budget,
                    device_hbm_limit, eval_budget_for_occupancy, joint_trainable_mask,
                    make_eval_step, make_lr_scheduler, make_optimizer, make_train_step,
                    optimizer_param_paths)


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
                         device: Optional[torch.device] = None, log_fn=print) -> Dict:
    """The joint param tree as a fresh run builds it: the seeded random
    init, overlaid with ``pretrained_sd`` where given, the IP heads copied
    from the U-Net's to_k/to_v (reference network.py:104-110), the frozen
    partition stored in ``cfg.train.frozen_dtype``.  A trainable-only
    restore rebuilds the frozen partition through this function, so it
    must stay deterministic in its inputs.  Runs on ``device`` (default
    cuda).

    ``pretrained_sd``: ``models.diffusion.weights.load_sdxl``'s dict.  Its
    CLIP text towers only compute the empty-prompt conditioning
    (``add_text_embeds``, ``add_time_ids``; reference network.py:114-168):
    they visit the device for that one call and are dropped.  Every other
    subtree (the VAE, the U-Net) is copied into the init's tensors in
    place, one leaf at a time, so the device never holds two U-Nets; its
    structure and shapes must match the init's, but the U-Net may lack
    the IP heads (``load_sdxl(with_ip=False)``), which are cloned from
    its to_k/to_v here in any case."""
    dev = resolve_device(device)
    overlay = dict(pretrained_sd or {})
    towers = [overlay.pop("text_encoder", None), overlay.pop("text_encoder_2", None)]
    cond = {}
    if None not in towers:
        te1, te2 = (tree_map(lambda x: x.to(dev), t) for t in towers)
        _, pooled, time_ids = make_empty_prompt_conditioning(te1, te2)
        del te1, te2
        cond = {"add_text_embeds": pooled, "add_time_ids": time_ids}
        log_fn(f"cached the empty-prompt conditioning of the text towers "
               f"(pooled mean {float(pooled.mean()):+.4f})")
    del towers
    sd_params = sd_network_init(seed_sd, cfg.sd, device=dev, **cond)
    for name, tree in overlay.items():
        if name not in sd_params:
            raise KeyError(f"pretrained weights hold {name!r}, which the SD network "
                           f"has not (it has {sorted(sd_params)})")
        copy_into(sd_params[name], tree, name, keep=("to_k_ip", "to_v_ip"))
    del overlay
    params = {"sd": init_ip_from_unet(sd_params),
              "nerf": nerf_init(seed_nerf, cfg.nerf, device=dev)}
    # the init's own IP heads (~1.4 GB at full width) are replaced: free
    # them before the frozen cast copies the tree
    del sd_params
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
    there as ``trace.json``.

    ``data_parallel`` (or a ``mesh`` from ``parallel.make_mesh``): this
    process is one rank of a data-parallel world (a world of one where no
    process group is initialized).  Each rank reads its own
    ``process_shard_indices`` slice of the train split, ``batch_size`` rows
    a step (the global batch is ``batch_size × world``), and every update
    applies the gradients averaged over the ranks, the NeRF's included.
    Params, optimizer and grid stay equal on every rank (the grid is
    broadcast from rank 0 after each refresh).  Rank 0 alone logs, writes
    ``metrics.jsonl``, runs the interleaved inference and writes the
    checkpoints, in the single-device format.  ``fsdp``: the SD tree and
    its AdamW moments are sharded over the ranks as well
    (``parallel.fsdp``), gathered whole for validation, inference and
    checkpoints; the returned params are whole.

    ``tensor_parallel`` > 1 (or a ``mesh`` from ``parallel.make_mesh_2d``):
    the world is a (data × model) mesh of ``world / tensor_parallel`` data
    ranks, the model axis innermost (counterpart of the JAX loop's 2-D
    mesh; the world must divide by ``tensor_parallel``, SDXL's heads admit
    2, 5 and 10).  The U-Net's attention and GEGLU leaves are cut over the
    model axis (``parallel.tp``), AdamW runs on each rank's slices, the
    ranks of a model group read the same rows and draws, and the gradients
    are averaged over the data axis alone; the global batch is
    ``batch_size × world / tensor_parallel``.  Validation and the
    interleaved inference run tensor-parallel too (inference on the model
    group of data rank 0); checkpoints are gathered and unpermuted into the
    single-device format, and a restore cuts them back.  With ``fsdp`` the
    rank's slices are sharded over the data axis as well."""
    dev = resolve_device(device)
    # a world of one made here is closed here; a launcher's group is adopted
    own_mesh = (mesh is None and (data_parallel or fsdp or tensor_parallel > 1)
                and not dist.is_initialized())
    if tensor_parallel > 1 and (mesh is None or mesh.shape.get("model") != tensor_parallel):
        kw = {} if mesh is None else {"backend": mesh.backend}
        mesh = make_mesh_2d(dev if mesh is None else mesh.device, tp=tensor_parallel, **kw)
    elif mesh is None and (data_parallel or fsdp):
        mesh = make_mesh(dev)
    if mesh is not None:
        dev = mesh.device
    preempt_flag, uninstall = _install_sigterm_flag()
    try:
        return _train_impl(cfg, dataset, workdir=workdir, seed=seed, epochs=epochs,
                           pretrained_sd=pretrained_sd, log_fn=log_fn, resume=resume,
                           profile_dir=profile_dir, preempt_flag=preempt_flag,
                           pretrained_fingerprint=pretrained_fingerprint, dev=dev,
                           mesh=mesh, fsdp=fsdp)
    finally:
        uninstall()
        if own_mesh:
            close_mesh()


def _train_impl(cfg: JointConfig, dataset, *, workdir: str, seed: int,
                epochs: Optional[int], pretrained_sd: Optional[Dict], log_fn,
                resume: bool, profile_dir: Optional[str], preempt_flag: Dict,
                pretrained_fingerprint: Optional[Dict], dev: torch.device,
                mesh=None, fsdp: bool = False):
    rank0 = mesh is None or mesh.rank == 0
    world = 1 if mesh is None else mesh.world
    # the data axis (the world of a 1-D mesh) and, under TP, the model axis
    data = None if mesh is None else mesh.axes["data"]
    model = None if mesh is None else mesh.axes.get("model")
    if model is not None and model.world == 1:
        model = None
    if not rank0:
        log_fn = lambda *a, **k: None      # noqa: E731 — rank 0 alone logs
    os.makedirs(workdir, exist_ok=True)

    def log_hbm(stage):
        """STABLE_NERF_LOG_HBM=1: the device's memory after each set-up stage."""
        if os.environ.get("STABLE_NERF_LOG_HBM") != "1":
            return
        for name, s in device_memory_stats().items():
            log_fn(f"hbm[{stage}] {name}: in_use={s['bytes_in_use'] / 2 ** 30:.2f} GB "
                   f"peak={s['peak_bytes_in_use'] / 2 ** 30:.2f} GB "
                   f"limit={s['bytes_limit'] / 2 ** 30:.2f} GB")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wait_all():
        """This rank's device work done, then every rank's."""
        sync()
        if mesh is not None:
            barrier(mesh)

    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    had_pretrained = pretrained_sd is not None
    params = build_initial_params(cfg, seed, seed + 1, pretrained_sd, device=dev,
                                  log_fn=log_fn)
    log_hbm("params-init")

    grid_state = mark_untrained_grid(
        grid_init(cfg.nerf, device=dev),
        torch.as_tensor(dataset.all_poses(), dtype=torch.float32, device=dev),
        dataset.intrinsic, cfg.nerf)
    if mesh is not None:
        # every rank starts from rank 0's bits
        replicate((params, list(grid_state)), mesh)
        log_fn(f"data parallel: rank {mesh.rank} of {world} on {dev} over "
               f"{mesh.backend}" + (", fully sharded" if fsdp else "")
               + (f", tensor parallel over {model.world} ({data.world} data ranks)"
                  if model is not None else ""))
    trainable_share = float((grid_state.density_grid >= 0).float().mean())
    log_fn(f"grid: {trainable_share:.4f} of the cells seen by a camera")

    mask = joint_trainable_mask(params, cfg.train.trainable_scope)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    if rank0:                  # rank 0 sweeps the directory before the others look
        ckpt = CheckpointManager(ckpt_dir)
    if mesh is not None:
        barrier(mesh)
    if not rank0:
        ckpt = CheckpointManager(ckpt_dir)
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

    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs    # noqa: E731
                            if isinstance(x, torch.Tensor))
    # the whole tree: what a step holds of the params (under FSDP, gathered)
    whole_param_bytes = nbytes(tree_leaves(params))
    layout = tp = None
    if fsdp:
        params, layout = place_joint_for_fsdp(params, data, tp_axis=model)
        tp = layout.tp
        log_fn(f"fsdp: {len(layout.leaves)} SD leaves sharded over {data.world} ranks; "
               f"{nbytes(tree_leaves(params))} of {whole_param_bytes} param bytes "
               f"held by a rank")
    elif model is not None:
        params, tp = place_joint_for_tp(params, model)
    if tp is not None:
        log_fn(f"tensor parallel: {len(tp.leaves)} U-Net leaves cut over {model.world} "
               f"ranks; {nbytes(tree_leaves(params))} of {whole_param_bytes} param "
               f"bytes held by a rank")
    optimizer = make_optimizer(cfg.train, params, mask)
    lr_scheduler = make_lr_scheduler(cfg.train, optimizer)
    param_paths = optimizer_param_paths(params, mask)

    def whole_params(tree):
        """``tree`` with its sharded leaves gathered, in the single-device
        layout (every rank calls it)."""
        if layout is not None:
            tree = layout.gather(tree, with_grad=False)
        return tp.gather(tree) if tp is not None else tree

    def tp_params(tree):
        """What a tensor-parallel step reads: the FSDP-gathered slices."""
        return layout.gather(tree, with_grad=False) if layout is not None else tree

    def save_ckpt(step_num: int, wait: bool = False):
        """Rank 0 writes the single-device format; under FSDP every rank
        first joins the gathers."""
        p, pk = params, "params"
        if t_only:
            p, _ = partition(p, mask)
            pk = "trainable"
        t0 = time.perf_counter()
        p = whole_params(p)
        opt_sd = (layout.optimizer_state_dict(optimizer) if layout is not None
                  else optimizer.state_dict())
        if tp is not None:
            opt_sd = tp.gather_optimizer_state(opt_sd, param_paths)
        opt_state = {"optimizer": opt_sd, "lr_scheduler": lr_scheduler.state_dict()}
        if rank0 and ckpt.save(step_num, p, opt_state, grid_state,
                               extra={"epoch": step_num}, wait=wait, params_key=pk,
                               fmt=ckpt_fmt):
            size = os.path.getsize(os.path.join(ckpt.directory, f"{step_num}.pt"))
            log_fn(f"checkpoint step {step_num} saved: {size} bytes in "
                   f"{time.perf_counter() - t0:.3f} s")
        del p, opt_state, opt_sd
        if mesh is not None:
            barrier(mesh)

    start_epoch = 0
    if resume:
        if ckpt.latest_step() is None:
            log_fn(f"WARNING: resume requested but no checkpoint found under "
                   f"{workdir}/checkpoints — starting from scratch")
        else:
            t0 = time.perf_counter()
            pk = "trainable" if t_only else "params"
            live = partition(params, mask)[0] if t_only else params
            template = {pk: live, "opt_state": None, "grid_state": grid_state,
                        "extra": None}
            if layout is None and tp is None:
                state = ckpt.restore(template=template)
            else:
                # a whole (single-device) checkpoint: cut each sharded leaf
                # and moment to this rank's slice, then block
                raw = ckpt.restore()
                if tp is not None:
                    raw[pk] = tp.shard(raw[pk])
                    raw["opt_state"]["optimizer"] = tp.shard_optimizer_state(
                        raw["opt_state"]["optimizer"], param_paths)
                if layout is not None:
                    raw[pk] = layout.shard_like(raw[pk])
                state = copy_into(template, raw)
            grid_state = state["grid_state"]
            if layout is None:
                optimizer.load_state_dict(state["opt_state"]["optimizer"])
            else:
                layout.load_optimizer_state_dict(optimizer, state["opt_state"]["optimizer"])
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
            step = make_train_step(
                step_cfg, scheduler, optimizer, lr_scheduler=lr_scheduler,
                sample_budget=budget, with_vis=with_vis, device=dev, mesh=data,
                fsdp=layout, tp_axis=model)
            step_cache[(budget, stochastic)] = (step if mesh is None
                                                else make_parallel_train_step(step, data))
        return step_cache[(budget, stochastic)]

    batch_size = cfg.train.batch_size
    cur_budget = cfg.train.sample_budget
    if cur_budget is None and not cfg.train.sample_budget_auto:
        # no budget given: dense unless the step would not fit the card
        limit = device_hbm_limit(dev)
        if limit:
            # AdamW holds two float32 moments a trainable leaf (of its slice
            # under FSDP, where the slices rest beside the gathered tree)
            trainable = [x for x in tree_leaves(partition(params, mask)[0])
                         if isinstance(x, torch.Tensor) and x.is_floating_point()]
            state_bytes = whole_param_bytes + 2 * nbytes(trainable) + nbytes(grid_state)
            if layout is not None:
                state_bytes += nbytes(tree_leaves(params))
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
                                                device=dev, tp_axis=model)
        return eval_cache[budget]

    def infer_for_budget(budget):
        if budget not in infer_cache:
            infer_cache[budget] = make_inference_step(
                cfg, scheduler, cfg.train.num_inference_steps, sample_budget=budget,
                device=dev, tp_axis=model)
        return infer_cache[budget]

    def density_fn(x):
        return nerf_density(params["nerf"], x, cfg.nerf)["sigma"] * cfg.nerf.density_scale

    def to_device(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}

    def should_stop():
        """The SIGTERM flag; the ranks agree on it (a signal reaches them at
        different times, and a lone early exit would hang the others' next
        collective)."""
        if world == 1:
            return preempt_flag["set"]
        flag = torch.tensor([float(preempt_flag["set"])], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
        return bool(flag.item())

    tr_idx, va_idx, te_idx = split_dataset(len(dataset), 0.8, 0.1, seed=seed)
    if data is not None and data.world > 1:
        tr_idx = tr_idx[process_shard_indices(len(tr_idx), data)]
    epochs = epochs if epochs is not None else cfg.train.epochs
    history = []
    timer = StepTimer()
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    # host RNG of the vis dumps, apart from the training draws
    vis_rng = random.Random(seed + 17)
    # the stream every rank shares (grid refresh, validation; under a mesh
    # each step folds it with the rank)
    generator = torch.Generator(device=dev).manual_seed(_stream_seed(seed, start_epoch))
    rays_per_step = 2 * batch_size * cfg.latent_hw ** 2
    preempted = False
    t_loop0 = time.perf_counter()

    for epoch in range(start_epoch, epochs):
        sync()
        t0 = time.perf_counter()
        grid_state = update_extra_state(grid_state, density_fn, cfg.nerf,
                                        generator=generator)
        if mesh is not None:
            replicate(list(grid_state), mesh)
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
            if should_stop():
                preempted = True
                break
            # trace a few steady steps of the first epoch run (step 0 warms
            # up); rank 0 alone writes the trace
            if profile_dir and epoch == start_epoch and rank0:
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
                # an independent draw a tensor; a copy only when sampled;
                # rank 0 dumps its own rows
                for prefix, tensor in vis.items():
                    if rank0:
                        sample_save_for_vis(prefix, tensor, cfg.train.vis_sample_prob,
                                            directory=os.path.join(workdir,
                                                                   "visualizations"),
                                            rng=vis_rng)
            else:
                m = out
            train_metrics.append(m)
        # the steps return before the card finishes them, and the epoch ends
        # when the slowest rank's does: wait before the clock
        wait_all()
        train_wall = time.perf_counter() - t_train0
        epoch_rays = rays_per_step * (1 if data is None else data.world) * len(train_metrics)
        timer.observe(steps=len(train_metrics), rays=epoch_rays, seconds=train_wall)
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

        run_val = cfg.train.val_every > 0 and (epoch % cfg.train.val_every == 0
                                               or epoch == epochs - 1)
        run_infer = (cfg.train.inference_every > 0
                     and (epoch + 1) % cfg.train.inference_every == 0 and len(te_idx) > 0)
        # validation and inference read the whole tree (under TP, this rank's
        # slices): gathered once under FSDP
        eval_params = ((tp_params if tp is not None else whole_params)(params)
                       if run_val or run_infer else None)

        val_metrics = []
        if run_val:
            # validation renders target + reference: 2B views
            t0 = time.perf_counter()
            eval_fn = eval_for_budget(eval_budget_for_occupancy(
                occ_frac, 2 * batch_size * cfg.latent_hw ** 2, cfg.train))
            for batch in iterate(dataset, va_idx, batch_size):
                val_metrics.append(eval_fn(eval_params, grid_state, to_device(batch),
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
        if rank0:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        log_fn(f"epoch {epoch}: train {record['train_loss']:.4f} "
               f"val {record['val_loss']:.4f} ({record['rays_per_sec']:.0f} rays/s, "
               f"{len(train_metrics)} steps in {train_wall:.3f} s)")

        # rank 0 serves; under TP with the rest of its model group
        if run_infer and (rank0 or model is not None and data.rank == 0):
            # inference renders the 2 target views of a batch
            t0 = time.perf_counter()
            infer_fn = infer_for_budget(eval_budget_for_occupancy(
                occ_frac, 2 * cfg.latent_hw ** 2, cfg.train))
            inf_metrics = []
            for i, batch in enumerate(iterate(dataset, te_idx, 2)):
                out = infer_fn(eval_params, grid_state, to_device(batch),
                               generator=generator)
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
            if inf_metrics and rank0:
                inf_record = {"epoch": epoch, "kind": "inference"}
                for k in inf_metrics[0]:
                    inf_record[f"inference_{k}"] = float(np.mean([m[k] for m in inf_metrics]))
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(inf_record) + "\n")
        del eval_params
        if mesh is not None and run_infer:
            barrier(mesh)

        if cfg.train.checkpoint_every > 0 and (epoch + 1) % cfg.train.checkpoint_every == 0:
            save_ckpt(epoch + 1)

    if epochs > start_epoch and not preempted:
        # not when no epoch ran: a resume with nothing left to do must not
        # rewrite the checkpoint it restored
        save_ckpt(epochs, wait=True)
    ckpt.wait_until_finished()
    return whole_params(params), grid_state, history
