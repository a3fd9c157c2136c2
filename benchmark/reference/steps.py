"""The reference's steps: the joint train step (VAE encode, NeRF render,
U-Net noise prediction, AdamW), the NeRF fit step (Adam), and a novel-view
request (eval render, DDIM, VAE decode), each in plain float32.

Follows the port's ``training/joint.py::forward_iteration``,
``training/inference.py::make_inference_step`` and
``scripts/fit_torch_nerf.py::train_step`` (stable_nerf_tpu_torch, as of
the benchmark's first version; reference train.py:23-107 and :323-432),
with the optimizers written out.  Every draw comes in ``draws``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import nerf, sd


def _gt(lt, B, C):
    return (lt.permute(0, 2, 3, 1).reshape(B, -1, C) + 1.0) / 2.0


def _dirs(rays_d, B, h):
    return rays_d.transpose(1, 2).reshape(B, 3, h, h)


def joint_losses(params, occ, batch, cfg, draws, ddim):
    """(loss, sd_loss, nerf_loss) of one joint step."""
    n, t, v = cfg["nerf"], cfg["train"], cfg["vae"]
    h, C = cfg["sd"]["latent_size"], n["channel_dim"]
    B = batch["target_image"].shape[0]
    with torch.no_grad():
        images = torch.cat([batch["target_image"], batch["reference_image"]])
        target_lt, reference_lt = sd.vae_encode_sample(params["sd"]["vae"], images, v,
                                                       draws["vae_eps"]).chunk(2)
    rays_o = torch.cat([batch["target_rays_o"], batch["reference_rays_o"]])
    rays_d = torch.cat([batch["target_rays_d"], batch["reference_rays_d"]])
    image = nerf.render(params["nerf"], occ, rays_o, rays_d, n, bg=t["bg_color"],
                        max_steps=t["max_steps_train"], perturb=draws["perturb"],
                        sample_budget=t["sample_budget"])
    pred_t, pred_r = image.chunk(2)
    nerf_loss = ((pred_t - _gt(target_lt, B, C)).abs().mean()
                 + (pred_r - _gt(reference_lt, B, C)).abs().mean())
    cond_t = pred_t.reshape(B, h, h, C).permute(0, 3, 1, 2) * 2.0 - 1.0
    embeds = torch.cat([torch.cat([cond_t, _dirs(batch["target_rays_d"], B, h)], 1),
                        torch.cat([reference_lt, _dirs(batch["reference_rays_d"], B, h)], 1)])
    noisy = ddim.add_noise(target_lt, draws["noise"], draws["timesteps"])
    pred = sd.sd_forward(params["sd"], noisy, draws["timesteps"], embeds, cfg,
                         params["sd"]["add_text_embeds"].float(),
                         params["sd"]["add_time_ids"].float())
    sd_loss = ((pred - draws["noise"]) ** 2).mean()
    return sd_loss + nerf_loss, sd_loss, nerf_loss


def fit_loss(params, occ, pool, cfg, idx, perturb, traffic):
    o, d, gt = pool["pool_o"][idx], pool["pool_d"][idx], pool["pool_gt"][idx]
    image = nerf.render(params, occ, o[None], d[None], cfg["nerf"], bg=traffic["bg"],
                        max_steps=traffic["max_steps"], perturb=perturb)[0]
    return ((image - gt) ** 2).mean()


class Adam:
    """torch.optim.Adam / AdamW's update, written out: decoupled weight
    decay ``wd`` (AdamW) or none (Adam), bias-corrected moments."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float, wd: float = 0.0):
        self.leaves, self.lr, self.b1, self.b2, self.eps, self.wd = leaves, lr, b1, b2, eps, wd
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr_factor: float = 1.0):
        self.t += 1
        lr = self.lr * lr_factor
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            if self.wd:
                p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + self.eps, value=-lr / c1)


def checked_steps(loss_fn, leaves: List[torch.Tensor], opt: Adam, n_steps: int,
                  lr_factors=None) -> Dict:
    """Run ``n_steps`` updates of ``leaves`` (float32, updated in place) by
    ``loss_fn(i)``; returns each step's loss, the first step's gradient
    norm by leaf and the change's norm by leaf after the last step."""
    start = [p.detach().clone() for p in leaves]
    losses, grad_norms = [], None
    for i in range(n_steps):
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(i)
        grads = torch.autograd.grad(loss, leaves)
        if i == 0:
            grad_norms = [float(g.norm()) for g in grads]
        opt.step(list(grads), 1.0 if lr_factors is None else lr_factors[i])
        losses.append(float(loss.detach()))
        del loss, grads
    change = [float((p.detach() - s).norm()) for p, s in zip(leaves, start)]
    for p in leaves:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


@torch.no_grad()
def request(params, occ, batch, cfg, draws, ddim, num_steps: int, budget: int):
    """One novel-view request → (denoised image [B, 3, H, W] in [0, 1], the
    rendered target latent [B, C, h, w])."""
    n, t, v = cfg["nerf"], cfg["train"], cfg["vae"]
    h, C = cfg["sd"]["latent_size"], n["channel_dim"]
    B = batch["target_image"].shape[0]
    reference_lt = sd.vae_encode_sample(params["sd"]["vae"], batch["reference_image"], v,
                                        draws["vae_eps"])
    image = nerf.render(params["nerf"], occ, batch["target_rays_o"], batch["target_rays_d"],
                        n, bg=t["bg_color"], max_steps=t["max_steps_eval"],
                        sample_budget=budget)
    pred_lt = image.reshape(B, h, h, C).permute(0, 3, 1, 2)
    embeds = torch.cat([torch.cat([pred_lt, _dirs(batch["target_rays_d"], B, h)], 1),
                        torch.cat([reference_lt, _dirs(batch["reference_rays_d"], B, h)], 1)])
    x = draws["init_latents"].float()
    te, ti = params["sd"]["add_text_embeds"].float(), params["sd"]["add_time_ids"].float()
    for ts in ddim.timesteps(num_steps):
        eps = sd.sd_forward(params["sd"], x, ts, embeds, cfg, te, ti)
        x = ddim.step(eps, ts, x, num_steps)
    decoded = sd.vae_decode(params["sd"]["vae"], x, v)
    return torch.clamp((decoded + 1.0) / 2.0, 0.0, 1.0), pred_lt
