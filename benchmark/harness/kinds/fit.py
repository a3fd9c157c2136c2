"""NeRF fit steps back to back, as ``scripts/fit_torch_nerf.py`` runs them:
random rays across every view, the dense march, the bf16 MLPs, the table
gradient through K1, Adam, and an occupancy refresh every
``refresh_every`` steps.

Set-up loads the views through the script's ``load_views``, makes the
weights from the seed, marks the grid, refreshes it (step 0) and drives
the step through its first three updates on rays drawn from the seed: the
warm-up and the checked steps.  The window goes on from step 3 with the
script's own generator pattern.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from ...reference import data as ref_data
from ...reference import nerf as ref_nerf
from ...reference import steps as ref_steps
from .. import common, inputs, program, weights

UNIT = "steps"


def _stochastic(ctx) -> bool:
    return ctx.traffic["encode"] == "stochastic"


def _args(ctx):
    return argparse.Namespace(dataset="synthetic", data_root=os.path.join(common.ROOT, "datasets"),
                              size=ctx.cfg["scene"]["size"])


def _draw(ctx, g):
    t = ctx.traffic
    views = ctx.cfg["scene"]
    pool = views["views"] * views["size"] ** 2
    return (torch.randint(0, pool, (t["rays"],), generator=g, device=ctx.device),
            torch.rand(t["rays"], generator=g, device=ctx.device))


def setup(ctx: common.Context) -> Dict:
    F = program.fit_module()
    cfg, dev, seed, t = ctx.cfg, ctx.device, ctx.seed, ctx.traffic
    ncfg = program.nerf_config(cfg["nerf"], hash_stochastic=_stochastic(ctx))
    views = F.load_views(_args(ctx), dev)
    if views["pool_o"].shape[0] != cfg["scene"]["views"] * cfg["scene"]["size"] ** 2:
        raise ValueError("the scene does not hold the configuration's views")
    common.mark(ctx, "imports and the views")
    params = inputs.nerf_weights(cfg, seed, dev)
    o = cfg["optimizer"]
    opt, sched = F.make_optimizer(params, o["lr"], o["decay_steps"], o["lr_decay"])
    common.mark(ctx, "weights and optimizer")
    state = F.refresh(F.init_state(ncfg, views, dev), params, ncfg,
                      draws=inputs.grid_noise(cfg, seed, dev))

    def step(idx, perturb):
        return F.train_step(params, opt, sched, s["grid"], views, ncfg, idx, perturb,
                            bg=t["bg"], max_steps=t["max_steps"], loss="mse", budget=None)

    common.mark(ctx, "grid")
    s = {"grid": state}
    leaves = common.optimizer_leaves(opt)
    paths = common.paths_of(params, leaves)
    start = [p.detach().clone() for p in leaves]
    g = weights.generator(seed, inputs.S_CHECKED, dev)
    losses, grad_norms = [], None
    for i in range(common.CHECKED_STEPS):
        losses.append(step(*_draw(ctx, g)))
        if i == 0:
            grad_norms = common.first_grad_norms(opt, leaves)
    checked = common.record(losses, grad_norms, start, leaves, paths)
    del start
    s.update(step=step, refresh=lambda gen: F.refresh(s["grid"], params, ncfg, generator=gen),
             params=params, n=common.CHECKED_STEPS, checked=checked,
             generator=weights.generator(seed, inputs.S_WINDOW, dev),
             bad=torch.zeros((), dtype=torch.int64, device=dev), spans={"grid_refresh": []})
    return s


def run_units(state: Dict, ctx: common.Context, seconds: float = None, count: int = None):
    """Steps until ``seconds`` have passed on the host clock, or ``count``
    steps, with the refresh every ``refresh_every`` steps (timed, ended by
    a synchronize, in a traced run)."""
    n, t0 = 0, common.now()
    every = int(ctx.traffic["refresh_every"])
    while (count is None and common.now() - t0 < seconds) or (count is not None and n < count):
        if state["n"] % every == 0:
            if ctx.trace:
                common.sync(ctx.device)
                tr = common.now()
            state["grid"] = state["refresh"](state["generator"])
            if ctx.trace:
                common.sync(ctx.device)
                state["spans"]["grid_refresh"].append(common.now() - tr)
        loss = state["step"](*_draw(ctx, state["generator"]))
        state["bad"] += (~torch.isfinite(loss)).long()
        state["n"] += 1
        n += 1
    return n


def failed(state: Dict) -> int:
    return int(state["bad"])


def trace_units(ctx) -> int:
    return int(ctx.traffic["refresh_every"])


def free(state: Dict) -> Dict:
    keep = {"checked": state["checked"], "spans": state["spans"]}
    state.clear()
    return keep


def reference_record(ctx: common.Context, precision_name: str = "reference") -> Dict:
    from ...reference import precision

    cfg, dev, seed, t = ctx.cfg, ctx.device, ctx.seed, ctx.traffic
    n = dict(cfg["nerf"], hash_stochastic=_stochastic(ctx))
    size = cfg["scene"]["size"]
    scene = ref_data.load_scene(ref_data.scene_path(common.ROOT), size, size, 0)
    gts = (torch.from_numpy(scene["reference_image"]).permute(0, 2, 3, 1) + 1.0) / 2.0
    pool = {"pool_o": torch.from_numpy(scene["reference_rays_o"]).reshape(-1, 3).to(dev),
            "pool_d": torch.from_numpy(scene["reference_rays_d"]).reshape(-1, 3).to(dev),
            "pool_gt": gts.reshape(-1, 3).to(dev)}
    params = inputs.nerf_weights(cfg, seed, dev)
    o = cfg["optimizer"]
    with precision.use(precision_name):
        grid = ref_nerf.grid_marked(n, torch.from_numpy(scene["reference_pose"]),
                                    scene["intrinsic"], dev)
        grid = ref_nerf.grid_refresh(grid, params, n, inputs.grid_noise(cfg, seed, dev))
        g = weights.generator(seed, inputs.S_CHECKED, dev)
        draws = [_draw(ctx, g) for _ in range(common.CHECKED_STEPS)]
        leaves_p = weights.leaves_with_path(params)
        opt = ref_steps.Adam([x for _, x in leaves_p], o["lr"], o["betas"][0], o["betas"][1],
                             o["eps"])
        factors = [o["lr_decay"] ** (i / o["decay_steps"]) if o["lr_decay"] < 1 else 1.0
                   for i in range(common.CHECKED_STEPS)]
        rec = ref_steps.checked_steps(
            lambda i: ref_steps.fit_loss(params, grid.occ, pool, {"nerf": n}, *draws[i], t),
            [x for _, x in leaves_p], opt, common.CHECKED_STEPS, factors)
    return common.by_path(rec, [p for p, _ in leaves_p])


def check(ctx: common.Context, kept: Dict) -> Dict[str, float]:
    return common.training_check(reference_record, ctx, kept)


def flops_per_unit(ctx: common.Context) -> float:
    from .. import flops

    t = ctx.traffic
    return float(flops.fit_step_flops(ctx.cfg, t["rays"], t["max_steps"], t["refresh_every"]))


def scatter_per_unit(ctx: common.Context):
    t = ctx.traffic
    return common.scatter_per_render(ctx.cfg["nerf"], t["rays"] * t["max_steps"],
                                     _stochastic(ctx))
