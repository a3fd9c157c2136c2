#!/usr/bin/env python
"""NeRF fitting driver of the PyTorch/CUDA port: the PSNR parity harness.

Counterpart of scripts/fit_nerf.py, with its flags, defaults and recipe
(torch-ngp's rather than the reference driver's, see that script's head):
random-ray minibatches drawn across all views every step, MSE loss,
trunc_exp density, an occupancy refresh every ``--update-every`` steps,
Adam(1e-2, betas (0.9, 0.99), eps 1e-15) with optax's exponential decay
(not staircase) to ``--lr-decay`` of the lr over ``--steps``.  The train
render computes in bf16, the eval render (every pixel of a view, no
jitter) in float32.  It ends with the line

    FINAL: mean PSNR over N views = X dB (per-view: [...])

which scripts/bench_hybrid_sweep.py parses.  ``--device`` (default cuda)
is the one flag the JAX script lacks.

Usage: python scripts/fit_torch_nerf.py [--dataset synthetic|nerf]
       [--data-root datasets] [--steps 3000] [--size 128] [--bg 1]
       [--stochastic [--stochastic-min-level L] | --stochastic-until N]
       [--sample-budget 0|N|auto] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stable_nerf_tpu_torch.config import NeRFConfig, TrainConfig  # noqa: E402
from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.grid import (grid_init,  # noqa: E402
                                                    mark_untrained_grid,
                                                    update_extra_state)
from stable_nerf_tpu_torch.models.nerf.network import nerf_density, nerf_init  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.renderer import render  # noqa: E402
from stable_nerf_tpu_torch.ops.compaction import suggest_sample_budget  # noqa: E402
from stable_nerf_tpu_torch.training.fit_graph import (fit_graph_eligible,  # noqa: E402
                                                      fit_graph_key, graph_step)
from stable_nerf_tpu_torch.training.joint import lr_factor  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402
from stable_nerf_tpu_torch.utils.losses import psnr  # noqa: E402
from stable_nerf_tpu_torch.utils.profiling import count, span  # noqa: E402
from stable_nerf_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from stable_nerf_tpu_torch.utils.visualization import save_image  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic (the committed scene) | nerf (tiny-NeRF data)")
    ap.add_argument("--data-root", default="datasets")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--lr-decay", type=float, default=0.1,
                    help="final lr as a fraction of --lr (exponential schedule); "
                         "1 = constant")
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--out", default="debug_out")
    ap.add_argument("--grid-size", type=int, default=128)
    ap.add_argument("--bg", type=float, default=1.0,
                    help="compositing background (1 suits white-background data)")
    ap.add_argument("--loss", default="mse", choices=["mse", "l1"])
    ap.add_argument("--sample-budget", default="0",
                    help="max NeRF-evaluated samples a train step; 0 = dense; 'auto' "
                         "= re-bucketed at each occupancy refresh "
                         "(ops.compaction.suggest_sample_budget).  A fixed budget "
                         "that binds in the early fog phase truncates rays and has "
                         "been measured to kill the fit: train dense, use 'auto', or "
                         "make it generous")
    ap.add_argument("--stochastic", action="store_true",
                    help="one-corner stochastic hash encode throughout training")
    ap.add_argument("--stochastic-until", type=int, default=0,
                    help="train the first N steps with the stochastic encode, then "
                         "the exact one; 0 = no schedule")
    ap.add_argument("--stochastic-min-level", type=int, default=0,
                    help="with --stochastic: keep levels below this exact (hybrid)")
    ap.add_argument("--density-act", default="trunc_exp", choices=["trunc_exp", "relu"])
    ap.add_argument("--no-custom-bwd", action="store_true",
                    help="table gradients through autograd instead of the scatter "
                         "kernel")
    ap.add_argument("--update-every", type=int, default=16,
                    help="occupancy-grid refresh cadence in steps")
    ap.add_argument("--psnr-views", type=int, default=8,
                    help="views averaged for the final PSNR report")
    ap.add_argument("--log-every", type=int, default=250)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fit runs (default cuda; raises without a card)")
    return ap


def nerf_config(args) -> NeRFConfig:
    return NeRFConfig(channel_dim=3, grid_size=args.grid_size,
                      hash_stochastic=args.stochastic,
                      hash_stochastic_min_level=args.stochastic_min_level,
                      density_activation=args.density_act,
                      hash_custom_bwd=not args.no_custom_bwd)


def warmup_config(cfg: NeRFConfig, args) -> NeRFConfig:
    """The same params and tables with the one-corner encode."""
    return dataclasses.replace(cfg, hash_stochastic=True,
                               hash_stochastic_min_level=args.stochastic_min_level)


def load_views(args, device: torch.device) -> Dict:
    """Every view of the dataset at ``--size``² on ``device``: targets in
    [0, 1] [N, HW, 3], rays [N, HW, 3], and the ray pool over all views."""
    H = W = args.size
    ds = StableNeRFDataset(args.dataset, shape=(H, W), encoded_shape=(H, W),
                           root=args.data_root)
    n = len(ds)
    images = torch.from_numpy(ds.reference_images).to(device)      # [N, 3, H, W] ±1
    gts = (images.permute(0, 2, 3, 1).reshape(n, -1, 3) + 1.0) / 2.0
    rays_o = torch.from_numpy(ds.reference_rays["rays_o"]).to(device)
    rays_d = torch.from_numpy(ds.reference_rays["rays_d"]).to(device)
    return {"n": n, "H": H, "W": W, "gts": gts, "rays_o": rays_o, "rays_d": rays_d,
            "pool_o": rays_o.reshape(-1, 3), "pool_d": rays_d.reshape(-1, 3),
            "pool_gt": gts.reshape(-1, 3), "intrinsic": ds.intrinsic,
            "poses": torch.from_numpy(ds.reference_poses).to(device)}


def make_optimizer(params: Dict, lr: float, steps: int, decay: float):
    """Adam over every NeRF leaf, as optax.adam(b1 0.9, b2 0.99, eps 1e-15)
    with ``exponential_decay(lr, steps, decay)`` (or a constant lr when
    ``decay`` is 1); returns (optimizer, LambdaLR or None).  On a card the
    Adam is ``capturable`` with its lr a 0-d tensor there, which the
    schedule fills in place, so ``train_step`` can replay it in a CUDA
    graph."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    dev = leaves[0].device
    if dev.type == "cuda":
        opt = torch.optim.Adam(leaves, lr=torch.tensor(lr, device=dev), betas=(0.9, 0.99),
                               eps=1e-15, capturable=True)
    else:
        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.99), eps=1e-15)
    if decay >= 1.0:
        return opt, None
    factor = lr_factor(TrainConfig(lr_schedule="exponential", lr_decay_steps=steps,
                                   lr_decay_factor=decay))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def init_state(cfg: NeRFConfig, views: Dict, device: torch.device):
    """The occupancy grid with the cells no view sees marked untrainable."""
    return mark_untrained_grid(grid_init(cfg, device=device), views["poses"],
                               views["intrinsic"], cfg)


def refresh(state, params: Dict, cfg: NeRFConfig, *, generator=None, draws=None):
    return update_extra_state(state, lambda x: nerf_density(params, x, cfg)["sigma"], cfg,
                              generator=generator, draws=draws)


def train_step(params: Dict, opt, sched, state, pool: Dict, cfg: NeRFConfig,
               idx: torch.Tensor, perturb: torch.Tensor, *, bg, max_steps: int,
               loss: str, budget: Optional[int],
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One Adam step on the rays ``idx`` of the pool (``pool_o``,
    ``pool_d``, ``pool_gt``), t0 jittered by ``perturb`` [rays] in [0, 1),
    the MLPs computing in ``compute_dtype`` (bf16, as the JAX script
    trains); returns the ``loss`` ("mse" or "l1"), a tensor of its own,
    not synchronised.

    Where ``fit_graph_eligible`` allows (every tensor on one card, the
    capturable Adam ``make_optimizer`` builds there, a dense step, the
    scatter backward) the step replays one CUDA graph kept for ``opt``
    (``training/fit_graph.py``), with ``idx``, ``perturb`` and the grid's
    ``occ`` copied into its buffers; it is captured at the first such call
    and again when ``fit_graph_key`` changes: the config, the ray count,
    ``max_steps``, ``bg``, ``loss``, ``compute_dtype``, a weight or pool
    tensor's storage, shape or dtype, or the optimizer's state.  A new
    grid state is no new key.  Elsewhere (the CPU, another optimizer, a
    sample budget) the step runs eagerly.  The schedule steps outside
    the graph.

    Spans and counters (``utils/profiling.py``): ``fit.step``, and in it,
    in an eager step only, ``fit.backward`` and ``fit.optimizer``;
    ``fit.steps`` and ``training/fit_graph.py``'s ``fit.graph_replays``
    and ``fit.graph_captures``."""

    def step(occ, idx, perturb):
        o, d, gt = pool["pool_o"][idx], pool["pool_d"][idx], pool["pool_gt"][idx]
        out = render(params, state._replace(occ=occ), o[None], d[None], cfg, bg_color=bg,
                     max_steps=max_steps, perturb=perturb, compute_dtype=compute_dtype,
                     sample_budget=budget)
        err = out["image"][0] - gt
        value = (err ** 2).mean() if loss == "mse" else err.abs().mean()
        opt.zero_grad(set_to_none=True)
        with span("fit.backward"):
            value.backward()
        with span("fit.optimizer"):
            opt.step()
        return value.detach()

    with span("fit.step"):
        count("fit.steps", 1)
        inputs = (state.occ, idx, perturb)
        tensors = [*tree_leaves(params), pool["pool_o"], pool["pool_d"], pool["pool_gt"]]
        if fit_graph_eligible(opt, budget, cfg.hash_custom_bwd, tensors + list(inputs)):
            settings = (cfg, max_steps, bg, loss, compute_dtype)
            value = graph_step(opt, lambda: fit_graph_key(opt, settings, tensors, inputs),
                               step, inputs)
        else:
            count("fit.graph_replays", 0)
            value = step(*inputs)
        if sched is not None:
            sched.step()
        return value


@torch.no_grad()
def render_view(params: Dict, state, views: Dict, i: int, cfg: NeRFConfig,
                args) -> torch.Tensor:
    """Every pixel of view ``i``, no jitter, float32 → [HW, 3]."""
    return render(params, state, views["rays_o"][i][None], views["rays_d"][i][None], cfg,
                  bg_color=args.bg, max_steps=args.max_steps)["image"][0]


def view_psnr(params: Dict, state, views: Dict, i: int, cfg: NeRFConfig, args):
    H, W = views["H"], views["W"]
    pred = render_view(params, state, views, i, cfg, args)
    p = psnr(pred.reshape(1, H, W, 3).permute(0, 3, 1, 2),
             views["gts"][i].reshape(1, H, W, 3).permute(0, 3, 1, 2))
    return pred, float(p[0, 0])


def mean_psnr(params: Dict, state, views: Dict, cfg: NeRFConfig, args) -> List[float]:
    return [view_psnr(params, state, views, i, cfg, args)[1]
            for i in range(min(args.psnr_views, views["n"]))]


def run(args, device: torch.device, log=print, start_psnr: bool = False) -> Dict:
    """The fit: returns {"params", "state", "views" (``load_views``),
    "losses" (one a step, on the host), "psnr" (the final per-view list),
    "train_s" (the steps' wall time, refreshes included, evaluations not)
    and, with ``start_psnr``, "start_psnr" (the per-view list of the
    initial params after the first refresh)}."""
    if args.stochastic and args.stochastic_until:
        sys.exit("--stochastic (one-corner throughout) and --stochastic-until "
                 "(warmup schedule, exact finish) are mutually exclusive — pick one")
    H, W = args.size, args.size
    cfg = nerf_config(args)
    cfg_warm = warmup_config(cfg, args)
    auto_budget = args.sample_budget == "auto"
    budget = None if auto_budget or int(args.sample_budget) <= 0 else int(args.sample_budget)
    views = load_views(args, device)
    log(f"{views['n']} views at {H}x{W}; {args.steps} steps x {args.rays_per_batch} rays, "
        f"loss={args.loss}, act={args.density_act}, bg={args.bg}")

    g = torch.Generator(device=device).manual_seed(0)
    params = nerf_init(0, cfg, device=device)
    state = init_state(cfg, views, device)
    opt, sched = make_optimizer(params, args.lr, args.steps, args.lr_decay)
    os.makedirs(args.out, exist_ok=True)
    n_pool = views["pool_o"].shape[0]
    result, losses = {}, []
    aside = 0.0                       # seconds of evaluation inside the loop
    t0 = time.perf_counter()
    for step in range(args.steps):
        if step % args.update_every == 0:
            state = refresh(state, params, cfg, generator=g)
            if auto_budget:
                budget = suggest_sample_budget(float(state.occ.float().mean()),
                                               args.rays_per_batch, args.max_steps)
            if step == 0 and start_psnr:
                t = time.perf_counter()
                result["start_psnr"] = mean_psnr(params, state, views, cfg, args)
                aside += time.perf_counter() - t
        if step == args.stochastic_until and args.stochastic_until:
            log(f"step {step}: warmup over — switching to the exact 8-corner encode")
        warming = args.stochastic or step < args.stochastic_until
        idx = torch.randint(0, n_pool, (args.rays_per_batch,), generator=g, device=device)
        perturb = torch.rand(args.rays_per_batch, generator=g, device=device)
        losses.append(train_step(params, opt, sched, state, views,
                                 cfg_warm if warming else cfg, idx, perturb, bg=args.bg,
                                 max_steps=args.max_steps, loss=args.loss, budget=budget))
        if (step + 1) % args.log_every == 0 or step == 0:
            t = time.perf_counter()
            pred, p = view_psnr(params, state, views, 0, cfg, args)
            occ = float(state.occ.float().mean())
            log(f"step {step + 1}: loss {float(losses[-1]):.6f} view0 PSNR {p:.2f} "
                f"occ {occ:.3f} {t - t0:.0f}s")
            save_image(os.path.join(args.out, f"pred_{step + 1}.png"),
                       pred.reshape(H, W, 3))
            save_image(os.path.join(args.out, "gt.png"), views["gts"][0].reshape(H, W, 3))
            aside += time.perf_counter() - t
    losses = [float(x) for x in losses]          # waits for the last step
    train_s = time.perf_counter() - t0 - aside
    result.update(params=params, state=state, views=views, train_s=train_s, losses=losses,
                  psnr=mean_psnr(params, state, views, cfg, args))
    return result


def final_line(ps: List[float]) -> str:
    return (f"FINAL: mean PSNR over {len(ps)} views = {np.mean(ps):.2f} dB "
            f"(per-view: {['%.2f' % v for v in ps]})")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    out = run(args, device, log=lambda s: print(s, flush=True))
    print(final_line(out["psnr"]), flush=True)


if __name__ == "__main__":
    main()
