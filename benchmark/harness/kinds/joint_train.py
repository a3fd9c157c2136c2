"""Joint train steps back to back, as the training loop runs them.

Set-up builds the flagship step (``training/joint.py::make_train_step``)
on weights made from the seed, marks and refreshes the occupancy grid as
the loop's first epoch does, and drives the step through its first three
updates on draws made from the seed: they are the warm-up and the checked
steps.  Batches of one scene come from the program's ``data/dataset.py``
and ``data/prefetch.py`` over the committed scene, the train split in an
order shuffled by the seed each epoch.  The window runs the same step
object on the loop's own generator.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict

import numpy as np
import torch

from ...reference import data as ref_data
from ...reference import nerf as ref_nerf
from ...reference import steps as ref_steps
from ...reference.sd import DDIM
from .. import common, inputs, program, weights

UNIT = "steps"


def _scene(ctx):
    cfg = ctx.cfg["sd"]
    return cfg["image_size"], cfg["latent_size"]


def setup(ctx: common.Context) -> Dict:
    from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset, iterate
    from stable_nerf_tpu_torch.data.prefetch import device_prefetch
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.nerf.grid import (grid_init, mark_untrained_grid,
                                                        update_extra_state)
    from stable_nerf_tpu_torch.models.nerf.network import nerf_density
    from stable_nerf_tpu_torch.training.joint import (cast_frozen, joint_trainable_mask,
                                                      make_optimizer, make_train_step)

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    jc = program.joint_config(cfg)
    img, lat = _scene(ctx)
    ds = StableNeRFDataset("synthetic", shape=(img, img), encoded_shape=(lat, lat),
                           root=os.path.join(common.ROOT, "datasets"), seed=seed)
    common.mark(ctx, "imports and the scene")
    params = inputs.joint_weights(cfg, seed, dev)
    common.mark(ctx, "weights")
    mask = joint_trainable_mask(params, jc.train.trainable_scope)
    params = cast_frozen(params, mask, jc.train.frozen_dtype)
    scheduler = DDIMScheduler.create(jc.sd.scheduler, device=dev)
    opt = make_optimizer(jc.train, params, mask)
    step = make_train_step(jc, scheduler, opt, sample_budget=jc.train.sample_budget,
                           device=dev)
    common.mark(ctx, "optimizer and step")
    grid = mark_untrained_grid(grid_init(jc.nerf, device=dev),
                               torch.as_tensor(ds.all_poses(), device=dev), ds.intrinsic,
                               jc.nerf)
    common.mark(ctx, "grid marked")
    grid = update_extra_state(
        grid, lambda x: nerf_density(params["nerf"], x, jc.nerf)["sigma"]
        * jc.nerf.density_scale, jc.nerf, draws=inputs.grid_noise(cfg, seed, dev))

    common.mark(ctx, "grid refreshed")
    train_idx, _, _ = inputs.split(len(ds), seed)
    B = jc.train.batch_size
    orders = (inputs.epoch_order(train_idx, seed, e) for e in itertools.count())
    batches = device_prefetch(itertools.chain.from_iterable(
        iterate(ds, order, B) for order in orders), device=dev)

    # the three checked steps: the warm-up, on draws made from the seed
    leaves = common.optimizer_leaves(opt)
    paths = common.paths_of(params, leaves)
    start = [p.detach().clone() for p in leaves]
    g = weights.generator(seed, inputs.S_CHECKED, dev)
    losses, grad_norms = [], None
    for i in range(common.CHECKED_STEPS):
        m = step(params, grid, next(batches), draws=inputs.joint_draws(cfg, g, dev))
        losses.append(m["loss"])
        if i == 0:
            grad_norms = common.first_grad_norms(opt, leaves)
    checked = common.record(losses, grad_norms, start, leaves, paths)
    del start
    return {"step": step, "params": params, "grid": grid, "batches": batches, "opt": opt,
            "checked": checked, "generator": weights.generator(seed, inputs.S_WINDOW, dev),
            "bad": torch.zeros((), dtype=torch.int64, device=dev), "spans": {"data_wait": []}}


def run_units(state: Dict, ctx: common.Context, seconds: float = None, count: int = None):
    """Steps until ``seconds`` have passed on the host clock, or ``count``
    steps; returns the number run (not waited for)."""
    n, t0 = 0, common.now()
    waits = state["spans"]["data_wait"]
    while (count is None and common.now() - t0 < seconds) or (count is not None and n < count):
        tw = common.now()
        batch = next(state["batches"])
        waits.append(common.now() - tw)
        m = state["step"](state["params"], state["grid"], batch, generator=state["generator"])
        state["bad"] += (~torch.isfinite(m["loss"])).long()
        n += 1
    return n


def failed(state: Dict) -> int:
    return int(state["bad"])


def trace_units(ctx) -> int:
    return int(ctx.traffic.get("traced_units", 2))


def free(state: Dict) -> Dict:
    keep = {"checked": state["checked"], "spans": state["spans"]}
    state.clear()
    return keep


def reference_record(ctx: common.Context, precision_name: str = "reference") -> Dict:
    """The plain reference's three checked steps on the same inputs."""
    from ...reference import precision

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    img, lat = _scene(ctx)
    scene = ref_data.load_scene(ref_data.scene_path(common.ROOT), img, lat, seed)
    params = inputs.joint_weights(cfg, seed, dev)
    n = cfg["nerf"]
    poses = torch.from_numpy(np.concatenate([scene["reference_pose"], scene["target_pose"]]))
    with precision.use(precision_name):
        grid = ref_nerf.grid_marked(n, poses, scene["intrinsic"], dev)
        grid = ref_nerf.grid_refresh(grid, params["nerf"], n, inputs.grid_noise(cfg, seed, dev))
        train_idx, _, _ = inputs.split(scene["reference_image"].shape[0], seed)
        order = inputs.epoch_order(train_idx, seed, 0)
        B = cfg["train"]["batch_size"]
        keys = [k for k in scene if k != "intrinsic"]
        batches = [{k: torch.from_numpy(scene[k][order[i * B:(i + 1) * B]]).to(dev)
                    for k in keys} for i in range(common.CHECKED_STEPS)]
        g = weights.generator(seed, inputs.S_CHECKED, dev)
        draws = [inputs.joint_draws(cfg, g, dev) for _ in range(common.CHECKED_STEPS)]
        leaves_p = [(p, x) for p, x in weights.leaves_with_path(params) if inputs.trainable(p)]
        t = cfg["train"]
        opt = ref_steps.Adam([x for _, x in leaves_p], t["lr"], t["adam_b1"], t["adam_b2"],
                             t["adam_eps"], t["weight_decay"])
        ddim = DDIM(cfg["scheduler"], dev)
        rec = ref_steps.checked_steps(
            lambda i: ref_steps.joint_losses(params, grid.occ, batches[i], cfg, draws[i],
                                             ddim)[0],
            [x for _, x in leaves_p], opt, common.CHECKED_STEPS)
    return common.by_path(rec, [p for p, _ in leaves_p])


def check(ctx: common.Context, kept: Dict) -> Dict[str, float]:
    return common.training_check(reference_record, ctx, kept)


def flops_per_unit(ctx: common.Context) -> float:
    from .. import flops

    return float(flops.joint_step_flops(ctx.cfg))


def scatter_per_unit(ctx: common.Context):
    """(K1 launches, K1 bytes) of one step."""
    t, lat = ctx.cfg["train"], ctx.cfg["sd"]["latent_size"]
    samples = 2 * t["batch_size"] * lat * lat * t["max_steps_train"]
    return common.scatter_per_render(ctx.cfg["nerf"], samples, ctx.cfg["nerf"]["hash_stochastic"])
