"""Novel-view requests one after another, as ``train.py --inference``
serves them (``training/inference.py::make_inference_step``): a batch of
test scenes, the eval render within the static eval budget, the DDIM
denoise, the VAE decode and the metrics.  A request is done when its
image is on the host.

Set-up builds the step on weights made from the seed, marks and refreshes
the occupancy grid, and serves one request (the warm-up).  Request ``r``'s
scenes and draws come from (seed, r), so any request can be served again
by the reference.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ...reference import data as ref_data
from ...reference import nerf as ref_nerf
from ...reference import steps as ref_steps
from ...reference.sd import DDIM
from .. import common, inputs, program

UNIT = "requests"


def _scene(ctx):
    return ctx.cfg["sd"]["image_size"], ctx.cfg["sd"]["latent_size"]


def budget(ctx) -> int:
    """The static eval budget (``training/joint.py::eval_sample_budget``'s
    rule, computed from the configuration)."""
    t, lat = ctx.cfg["train"], ctx.cfg["sd"]["latent_size"]
    rays = ctx.traffic["batch"] * lat * lat
    if t["sample_budget_eval"] is not None:
        return t["sample_budget_eval"]
    return min(rays * t["sample_budget_eval_per_ray"], rays * t["max_steps_eval"])


def setup(ctx: common.Context) -> Dict:
    from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset, collate
    from stable_nerf_tpu_torch.data.prefetch import device_prefetch
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.nerf.grid import (grid_init, mark_untrained_grid,
                                                        update_extra_state)
    from stable_nerf_tpu_torch.models.nerf.network import nerf_density
    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.training.joint import cast_frozen, joint_trainable_mask

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    jc = program.joint_config(cfg)
    img, lat = _scene(ctx)
    ds = StableNeRFDataset("synthetic", shape=(img, img), encoded_shape=(lat, lat),
                           root=os.path.join(common.ROOT, "datasets"), seed=seed)
    common.mark(ctx, "imports and the scene")
    params = inputs.joint_weights(cfg, seed, dev, ctx.traffic.get("table_scale"))
    common.mark(ctx, "weights")
    mask = joint_trainable_mask(params, jc.train.trainable_scope)
    params = cast_frozen(params, mask, jc.train.frozen_dtype)
    with torch.no_grad():
        grid = mark_untrained_grid(grid_init(jc.nerf, device=dev),
                                   torch.as_tensor(ds.all_poses(), device=dev), ds.intrinsic,
                                   jc.nerf)
        grid = update_extra_state(
            grid, lambda x: nerf_density(params["nerf"], x, jc.nerf)["sigma"]
            * jc.nerf.density_scale, jc.nerf, draws=inputs.grid_noise(cfg, seed, dev))

    common.mark(ctx, "grid")
    stages = []
    hook = None
    if ctx.trace:
        def hook(name):
            common.sync(dev)
            stages.append((name, common.now()))

    scheduler = DDIMScheduler.create(jc.sd.scheduler, device=dev)
    serve = make_inference_step(jc, scheduler, ctx.traffic["ddim_steps"],
                                compute_dtype=torch.bfloat16,
                                guidance_scale=float(ctx.traffic["guidance"]), device=dev,
                                stage_hook=hook)
    _, _, test = inputs.split(len(ds), seed)

    def requests():
        r = 0
        while True:
            scenes = inputs.request_scenes(test, ctx.traffic["batch"], seed, r)
            yield collate([ds[int(i)] for i in scenes])
            r += 1

    state = {"serve": serve, "params": params, "grid": grid, "stages": stages,
             "batches": device_prefetch(requests(), size=1, device=dev), "r": 0,
             "outputs": {}, "bad": 0, "spans": {"stages": stages, "request": []}}
    run_units(state, ctx, count=1)                 # the warm-up request
    stages.clear()
    state["spans"]["request"].clear()
    return state


def run_units(state: Dict, ctx: common.Context, seconds: float = None, count: int = None):
    """Requests until ``seconds`` have passed and the one in flight is done,
    or ``count`` requests; each one waits for its image."""
    n, t0 = 0, common.now()
    while (count is None and common.now() - t0 < seconds) or (count is not None and n < count):
        r = state["r"]
        draws = inputs.request_draws(ctx.cfg, ctx.traffic["batch"], ctx.seed, r, ctx.device)
        t_req = common.now()
        state["stages"].append(("start", t_req))
        out = state["serve"](state["params"], state["grid"], next(state["batches"]),
                             draws=draws)
        image = out["denoised_image"].cpu()
        state["outputs"][r] = (image, out["pred_target_latent"].cpu())
        state["bad"] += int(not torch.isfinite(image).all())
        state["spans"]["request"].append(common.now() - t_req)
        state["r"] += 1
        n += 1
    return n


def failed(state: Dict) -> int:
    return state["bad"]


def trace_units(ctx) -> int:
    return int(ctx.traffic.get("traced_units", 1))


def sampled(ctx: common.Context, done) -> list:
    """The requests the check serves again: ``check_requests`` of those the
    window finished, drawn from the seed, the first one always in."""
    done = sorted(done)
    k = min(int(ctx.traffic["check_requests"]), len(done))
    rest = np.random.default_rng([ctx.seed, 7]).choice(done[1:], size=k - 1, replace=False)
    return [done[0]] + sorted(int(r) for r in rest)


def free(state: Dict) -> Dict:
    keep = {"outputs": state["outputs"], "spans": state["spans"]}
    state.clear()
    return keep


def reference_outputs(ctx: common.Context, requests, precision_name: str = "reference"):
    """{r: (image, rendered latent)} of the plain reference."""
    from ...reference import precision

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    if float(ctx.traffic["guidance"]) != 1.0:
        raise ValueError("the reference serves guidance 1 only")
    img, lat = _scene(ctx)
    scene = ref_data.load_scene(ref_data.scene_path(common.ROOT), img, lat, seed)
    params = inputs.joint_weights(cfg, seed, dev, ctx.traffic.get("table_scale"))
    n = cfg["nerf"]
    poses = torch.from_numpy(np.concatenate([scene["reference_pose"], scene["target_pose"]]))
    _, _, test = inputs.split(scene["reference_image"].shape[0], seed)
    keys = [k for k in scene if k != "intrinsic"]
    ddim = DDIM(cfg["scheduler"], dev)
    out = {}
    with precision.use(precision_name):
        grid = ref_nerf.grid_marked(n, poses, scene["intrinsic"], dev)
        grid = ref_nerf.grid_refresh(grid, params["nerf"], n, inputs.grid_noise(cfg, seed, dev))
        for r in requests:
            idx = inputs.request_scenes(test, ctx.traffic["batch"], seed, r)
            batch = {k: torch.from_numpy(scene[k][idx]).to(dev) for k in keys}
            draws = inputs.request_draws(cfg, ctx.traffic["batch"], seed, r, dev)
            image, lt = ref_steps.request(params, grid.occ, batch, cfg, draws, ddim,
                                          ctx.traffic["ddim_steps"], budget(ctx))
            out[r] = (image.cpu(), lt.cpu())
    return out


def check(ctx: common.Context, kept: Dict) -> Dict[str, float]:
    """Two requests the window finished, served again by the reference."""
    from .. import compare

    reqs = sampled(ctx, kept["outputs"])
    ref = reference_outputs(ctx, reqs)
    out = kept["outputs"]
    return compare.image_gaps([out[r][0] for r in reqs], [ref[r][0] for r in reqs],
                              [out[r][1] for r in reqs], [ref[r][1] for r in reqs])


def flops_per_unit(ctx: common.Context) -> float:
    from .. import flops

    return float(flops.request_flops(ctx.cfg, ctx.traffic["batch"], ctx.traffic["ddim_steps"],
                                     budget(ctx)))


def scatter_per_unit(ctx: common.Context):
    return 0, 0
