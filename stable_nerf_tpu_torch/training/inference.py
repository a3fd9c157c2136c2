"""DDIM-sampling inference: NeRF-conditioned novel-view generation
(counterpart of stable_nerf_tpu/training/inference.py; reference
train.py:323-432).

Per batch: encode the reference image with the VAE, render the target
view's latent with the NeRF (eval march, budgeted), assemble the two
7-channel conditions, run an eta = 0 DDIM denoise from pure noise, decode,
and score against the ground-truth target image.

Reference quirks kept:
  * the NeRF latent is not renormalized ×2−1 here, unlike training
    (train.py:371 vs :75);
  * no classifier-free guidance by default.  ``guidance_scale != 1`` runs
    the conditional and the unconditional stream (image conditioning
    zeroed) as one doubled-batch U-Net call.

``make_sharded_inference_step`` serves the same step with the U-Net
tensor- and sequence-parallel over a mesh of processes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.diffusion.scheduler import DDIMScheduler
from ..models.diffusion.sd_network import (decode_latents, encode_images,
                                           encode_images_mode, sd_forward)
from ..models.nerf.grid import OccupancyGridState
from ..models.nerf.renderer import render
from ..utils.device import resolve_device
from ..utils.losses import l2_loss, psnr, ssim
from .joint import JointConfig, check_batch_device, eval_sample_budget


def make_inference_step(cfg: JointConfig, scheduler: DDIMScheduler,
                        num_steps: int = 50, *, compute_dtype=torch.bfloat16,
                        guidance_scale: float = 1.0,
                        capture_attn_maps: bool = False,
                        sample_budget: Optional[int] = None,
                        device: Optional[torch.device] = None,
                        stage_hook: Optional[Callable[[str], None]] = None,
                        tp_axis=None, sp_axis=None):
    """Build the per-batch inference function.

    sample_budget: explicit NeRF eval-render budget (e.g. the one from
      ``eval_budget_for_occupancy``); None → the static 64/ray default.
    guidance_scale: 1.0 is one conditional pass; otherwise each DDIM step
      extrapolates ``eps = eps_uncond + s·(eps_cond − eps_uncond)``.
    capture_attn_maps: also return ``ip_attn_maps``, the ip-stream
      cross-attention probability maps of the final DDIM step (outermost
      layer first; the conditional stream's under guidance).

    stage_hook: called with a stage's name as it ends ("encode", "render",
      "denoise", "decode"), so a caller can synchronize and read a clock
      there; None adds nothing to the step.
    tp_axis / sp_axis: mesh axes every U-Net call (the unconditional pass
      under guidance included) runs tensor- and sequence-parallel over; see
      ``make_sharded_inference_step``.

    Returns ``step(params, grid_state, batch, generator=None, draws=None)``
    → dict with the denoised view and PSNR/SSIM/L2 against the target.
    ``draws`` may inject ``vae_eps`` [B, 4, h, w] (the reference encode's
    normal draw) and ``init_latents`` [B, 4, h, w]; any that is missing is
    drawn from ``generator``.  Runs on ``device`` (default cuda), no grad.
    """
    dev = resolve_device(device)
    # the whole schedule goes to the device once, not one scalar per step
    ts = torch.as_tensor(scheduler.timesteps(num_steps), device=dev)
    stage_end = stage_hook or (lambda name: None)
    guided = guidance_scale != 1.0

    @torch.no_grad()
    def step(params: Dict, grid_state: OccupancyGridState, batch: Dict,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        draws = draws or {}
        enc = cfg.latent_hw
        C = cfg.nerf.channel_dim
        target_image = batch["target_image"]
        reference_image = batch["reference_image"]
        check_batch_device(batch, dev)
        B = target_image.shape[0]

        # cond 1: VAE latent of the reference view
        if cfg.train.vae_encode == "mode":
            reference_lt = encode_images_mode(params["sd"], reference_image, cfg.sd)
        else:
            reference_lt = encode_images(params["sd"], reference_image, cfg.sd,
                                         eps=draws.get("vae_eps"), generator=generator)
        stage_end("encode")

        # cond 2: NeRF-rendered target latent, eval march; not ×2−1
        out = render(
            params["nerf"], grid_state, batch["target_rays_o"],
            batch["target_rays_d"], cfg.nerf, bg_color=cfg.train.bg_color,
            max_steps=cfg.train.max_steps_eval, compute_dtype=compute_dtype,
            sample_budget=(sample_budget if sample_budget is not None
                           else eval_sample_budget(B * enc * enc, cfg.train)))
        pred_target_lt = out["image"].reshape(B, enc, enc, C).permute(0, 3, 1, 2)
        stage_end("render")

        t_dirs = batch["target_rays_d"].transpose(1, 2).reshape(B, 3, enc, enc)
        r_dirs = batch["reference_rays_d"].transpose(1, 2).reshape(B, 3, enc, enc)
        image_embeds = torch.cat([torch.cat([pred_target_lt, t_dirs], dim=1),
                                  torch.cat([reference_lt, r_dirs], dim=1)], dim=0)
        if guided:
            image_embeds = torch.cat([image_embeds, torch.zeros_like(image_embeds)])

        def unet_eps(x, t, capture=False):
            res = sd_forward(params["sd"], torch.cat([x, x]) if guided else x, t,
                             image_embeds, cfg.sd, compute_dtype=compute_dtype,
                             capture_ip_attn_maps=capture, tp_axis=tp_axis,
                             sp_axis=sp_axis)
            eps, maps = res if capture else (res, None)
            if guided:
                # cond ++ uncond in one call; keep the conditional maps
                if maps is not None:
                    maps = [m[: m.shape[0] // 2] for m in maps]
                eps_cond, eps_uncond = eps.chunk(2, dim=0)
                eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
            return eps, maps

        # DDIM from pure noise
        latents = draws.get("init_latents")
        if latents is None:
            if generator is None:
                raise ValueError("draw 'init_latents' was not given and no "
                                 "generator was")
            latents = torch.randn(reference_lt.shape, generator=generator, device=dev)
        ip_attn_maps = None
        for i, t in enumerate(ts):
            last = i == len(ts) - 1
            eps, maps = unet_eps(latents, t, capture=capture_attn_maps and last)
            latents, _ = scheduler.step(eps, t, latents, num_inference_steps=num_steps)
            if maps is not None:
                ip_attn_maps = maps
        stage_end("denoise")

        decoded = decode_latents(params["sd"], latents.float(), cfg.sd)
        pred = torch.clamp((decoded + 1.0) / 2.0, 0.0, 1.0)
        gt = torch.clamp((target_image + 1.0) / 2.0, 0.0, 1.0)

        # NeRF-side quality of the novel-view latent, independent of the
        # diffusion weights: PSNR of the render against the mode encode of
        # the target view, both in the normalized space the joint loss
        # supervises ((lt + 1) / 2)
        target_lt = encode_images_mode(params["sd"], target_image, cfg.sd)
        result = {
            "denoised_image": pred,
            "target_image": gt,
            "latent_psnr": psnr(pred_target_lt, (target_lt + 1.0) / 2.0),
            "reference_image": torch.clamp((reference_image + 1) / 2, 0, 1),
            "pred_target_latent": pred_target_lt,
            "l2_loss": l2_loss(pred, gt),
            "psnr": psnr(pred, gt),
            "ssim": ssim(pred, gt),
        }
        if ip_attn_maps is not None:
            result["ip_attn_maps"] = ip_attn_maps
        stage_end("decode")
        return result

    return step


def make_sharded_inference_step(cfg: JointConfig, scheduler: DDIMScheduler,
                                num_steps: int = 50, *, mesh, tp: int = 1, sp: int = 1,
                                compute_dtype=torch.bfloat16, guidance_scale: float = 1.0,
                                capture_attn_maps: bool = False,
                                sample_budget: Optional[int] = None,
                                stage_hook: Optional[Callable[[str], None]] = None):
    """The inference step with the U-Net tensor-parallel over ``mesh``'s
    ``model`` axis (heads and GEGLU width; tp ∈ {2, 5, 10} for SDXL) and
    sequence-parallel over its ``seq`` axis (ring attention over latent
    tokens): the counterpart of the JAX package's shard_map serving
    wrapper.  ``mesh`` is ``parallel.make_mesh_3d(sp=sp, tp=tp)``'s.  The
    NeRF render, the VAE and the metrics run replicated on every rank.

    Returns ``build(params) -> (local_params, fn)``: call it once with the
    whole joint tree (GEGLU kernels permuted and the sharded leaves cut to
    this rank's slices), then ``fn(local_params, grid_state, batch,
    generator=None, draws=None)`` as the unsharded step.  Every rank of the
    mesh calls ``fn`` with the same batch and draws or a generator of the
    same state: the generator is not folded with the rank (JAX's key is
    replicated), so every rank draws the same noise and returns the same
    ``denoised_image``.  Runs on the mesh's device."""
    from ..parallel.sp import serving_param_specs
    from ..parallel.tp import axis_block
    from ..utils.tree import tree_map

    if mesh.shape.get("model", 1) != tp or mesh.shape.get("seq", 1) != sp:
        raise ValueError(f"mesh {mesh.shape} is not seq={sp} x model={tp}")
    tp_axis = mesh.axes["model"] if tp > 1 else None
    sp_axis = mesh.axes["seq"] if sp > 1 else None
    step = make_inference_step(cfg, scheduler, num_steps, compute_dtype=compute_dtype,
                               guidance_scale=guidance_scale,
                               capture_attn_maps=capture_attn_maps,
                               sample_budget=sample_budget, device=mesh.device,
                               stage_hook=stage_hook, tp_axis=tp_axis, sp_axis=sp_axis)

    def build(params: Dict):
        if tp_axis is None:
            return params, step
        params, specs = serving_param_specs(params, tp, unet_keys=("sd", "unet"))
        with torch.no_grad():
            local = tree_map(lambda x, d: x if d is None else
                             axis_block(x, d, tp_axis).contiguous().clone(), params, specs)
        return local, step

    return build
