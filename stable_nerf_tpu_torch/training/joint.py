"""The joint Stable-NeRF train and validation steps (counterpart of
stable_nerf_tpu/training/joint.py; reference train.py:23-107):

  1. frozen-VAE encode of the (target, reference) images, no grad;
  2. latent ground truth normalized to [0, 1];
  3. NeRF render of target + reference rays at the latent resolution;
  4. nerf_loss = L1(pred_target, gt_target) + L1(pred_ref, gt_ref);
  5. conditions [pred_target·2−1 | target dirs] and [ref latent | ref dirs];
  6. random timesteps + DDIM add_noise on the target latent;
  7. frozen U-Net + IP-Adapter noise prediction;
  8. sd_loss = MSE(noise_pred, noise).

Gradients reach only the trainable partition: frozen tensors have
``requires_grad`` off, so autograd computes no frozen weight gradients.
The random draws (VAE eps, noise, timesteps, ray perturbation) can be
injected, so a test can feed both packages the same numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..config import NeRFConfig, TrainConfig
from ..models.diffusion.scheduler import DDIMScheduler
from ..models.diffusion.sd_network import (SDNetworkConfig, encode_images,
                                           encode_images_mode, sd_forward)
from ..models.diffusion.sd_network import trainable_mask as sd_trainable_mask
from ..models.nerf.grid import OccupancyGridState
from ..models.nerf.renderer import render
from ..ops.compaction import suggest_sample_budget
from ..parallel.fsdp import global_token_pairing
from ..parallel.sharding import all_reduce_mean_
from ..utils.device import resolve_device
from ..utils.losses import l1_loss, mse_loss
from ..utils.tree import tree_leaves, tree_leaves_with_path, tree_map


# Memory model of the full-width train step on an NVIDIA H100 80GB HBM3,
# solved from two measured peaks of chip_smoke.py (dense 2,097,152 samples
# and a 262,144-sample budget; PERF.md has both points)
BYTES_PER_SAMPLE = 1953
FIXED_TEMP_FRAC = 0.40


@dataclass(frozen=True)
class JointConfig:
    nerf: NeRFConfig = field(default_factory=lambda: NeRFConfig(channel_dim=4))
    sd: SDNetworkConfig = field(default_factory=SDNetworkConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def latent_hw(self) -> int:
        return self.sd.sd.latent_size


def eval_sample_budget(n_rays: int, cfg: TrainConfig) -> Optional[int]:
    """Static eval-render sample budget: explicit override, else 64/ray;
    None → dense lattice eval."""
    if cfg.sample_budget_eval is not None:
        return cfg.sample_budget_eval
    if cfg.sample_budget_eval_per_ray <= 0:
        return None
    return min(n_rays * cfg.sample_budget_eval_per_ray, n_rays * cfg.max_steps_eval)


def eval_budget_for_occupancy(occ_fraction: Optional[float], n_rays: int,
                              cfg: TrainConfig) -> Optional[int]:
    """Occupancy-driven eval budget: ``suggest_sample_budget`` of the grid's
    measured occupied fraction, capped by the static budget.  Falls back to
    the static budget when auto is off, an explicit override is set, no
    measurement is given, or the estimate reaches the dense lattice."""
    static = eval_sample_budget(n_rays, cfg)
    if (occ_fraction is None or not cfg.sample_budget_eval_auto
            or cfg.sample_budget_eval is not None):
        return static
    budget = suggest_sample_budget(occ_fraction, n_rays, cfg.max_steps_eval)
    if budget is None:
        return static
    return budget if static is None else min(budget, static)


def device_hbm_limit(device) -> Optional[int]:
    """Total device memory of a CUDA ``device`` in bytes; None for any
    other device (callers then leave the budget dense)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def derive_train_sample_budget(n_rays: int, max_steps: int, state_bytes: int,
                               hbm_limit_bytes: int, *,
                               bytes_per_sample: int = BYTES_PER_SAMPLE,
                               fixed_temp_frac: float = FIXED_TEMP_FRAC,
                               reserve_bytes: int = 2 ** 28,
                               min_budget: int = 2 ** 16) -> Optional[int]:
    """Memory-envelope default for the train-side sample budget: size the
    NeRF march's compaction budget so the whole step fits the device.

        step memory ≈ state + fixed_temp_frac·state + bytes_per_sample·budget

    where ``state`` is params + optimizer + grid + batch and the second
    term is the budget-independent U-Net/VAE activations.  Returns None
    (dense lattice: exact, preferred) when dense fits, else the largest
    power of two that fits, floored at ``min_budget``."""
    dense = n_rays * max_steps
    fixed = fixed_temp_frac * state_bytes
    avail = hbm_limit_bytes - state_bytes - fixed - reserve_bytes
    if avail >= dense * bytes_per_sample:
        return None
    max_samples = max(avail / bytes_per_sample, 1.0)
    budget = max(min_budget, 1 << int(math.floor(math.log2(max_samples))))
    return None if budget >= dense else budget


def joint_trainable_mask(params: Dict, scope: str = "reference") -> Dict:
    """Bool tree over {'sd', 'nerf'}: ``reference`` trains the ip head and
    the NeRF (train.py:179-182); ``sd`` also trains the whole U-Net.  The
    VAE and the cached prompt conditioning stay frozen in every scope."""
    if scope == "reference":
        sd_mask = sd_trainable_mask(params["sd"])
    elif scope == "sd":
        sd_mask = {k: tree_map(lambda _, k=k: k not in ("vae", "add_text_embeds",
                                                         "add_time_ids"), v)
                   for k, v in params["sd"].items()}
    else:
        raise ValueError(f"unknown trainable scope {scope!r} (reference | sd)")
    return {"sd": sd_mask, "nerf": tree_map(lambda _: True, params["nerf"])}


def cast_frozen(params: Dict, mask: Dict, dtype: Optional[str]) -> Dict:
    """Store the frozen floating-point leaves in ``dtype`` (``TrainConfig.
    frozen_dtype``; None keeps float32).  Trainable leaves stay float32."""
    if dtype is None:
        return params
    dt = getattr(torch, dtype)
    return tree_map(lambda x, m: x if m or not x.is_floating_point() else x.to(dt),
                    params, mask)


def forward_iteration(params: Dict, grid_state: OccupancyGridState, batch: Dict,
                      cfg: JointConfig, scheduler: DDIMScheduler, *,
                      train: bool = True, compute_dtype=torch.bfloat16,
                      sample_budget: Optional[int] = None,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      pair_tokens: Optional[Callable] = None, tp_axis=None):
    """One joint forward pass → (sd_loss, nerf_loss, aux).

    draws: optional injected random numbers — ``vae_eps`` [2B, 4, h, w]
      standard normal, ``noise`` [B, 4, h, w], ``timesteps`` [B] int and
      ``perturb`` [2B·rays] uniform; any that is missing is drawn from
      ``generator``.
    pair_tokens: ``sd_network.embed_conditions``' pairing of the ip tokens,
      where it is not the local reshape.
    tp_axis: the model axis the U-Net runs tensor-parallel over (its
      params this rank's slices, ``parallel.tp.place_joint_for_tp``).
    """
    draws = draws or {}

    def draw(name, make):
        if name in draws:
            return draws[name]
        if generator is None:
            raise ValueError(f"draw {name!r} was not given and no generator was")
        return make()

    enc = cfg.latent_hw
    C = cfg.nerf.channel_dim
    target_image = batch["target_image"]
    B = target_image.shape[0]
    dev = target_image.device

    # 1. frozen VAE encode in the images' dtype (float32), no grad
    images = torch.cat([target_image, batch["reference_image"]], dim=0)
    with torch.no_grad():
        if cfg.train.vae_encode == "mode":
            latents = encode_images_mode(params["sd"], images, cfg.sd)
        else:
            latents = encode_images(params["sd"], images, cfg.sd,
                                    eps=draws.get("vae_eps"), generator=generator)
    target_lt, reference_lt = latents.chunk(2, dim=0)

    # 2. latent GT → [B, h·w, C] in [0, 1]
    def to_gt(lt):
        return (lt.permute(0, 2, 3, 1).reshape(B, -1, C) + 1.0) / 2.0

    # 3. NeRF render, target and reference batched
    rays_o = torch.cat([batch["target_rays_o"], batch["reference_rays_o"]], 0)
    rays_d = torch.cat([batch["target_rays_d"], batch["reference_rays_d"]], 0)
    n_rays = rays_o.shape[0] * rays_o.shape[1]
    perturb = None
    if train:
        perturb = draw("perturb", lambda: torch.rand(n_rays, generator=generator,
                                                     device=dev))
    elif sample_budget is None:
        sample_budget = eval_sample_budget(n_rays, cfg.train)
    out = render(params["nerf"], grid_state, rays_o, rays_d, cfg.nerf,
                 bg_color=cfg.train.bg_color,
                 max_steps=cfg.train.max_steps_train if train else cfg.train.max_steps_eval,
                 perturb=perturb, compute_dtype=compute_dtype,
                 sample_budget=sample_budget)
    pred_target, pred_reference = out["image"].chunk(2, dim=0)

    # 4. reconstruction loss
    nerf_loss = (l1_loss(pred_target, to_gt(target_lt))
                 + l1_loss(pred_reference, to_gt(reference_lt)))

    # 5. conditions: NeRF target latent ×2−1; the reference condition uses
    #    the VAE latent, not the render
    pred_target_lt = pred_target.reshape(B, enc, enc, C).permute(0, 3, 1, 2) * 2.0 - 1.0
    t_dirs = batch["target_rays_d"].transpose(1, 2).reshape(B, 3, enc, enc)
    r_dirs = batch["reference_rays_d"].transpose(1, 2).reshape(B, 3, enc, enc)
    image_embeds = torch.cat([torch.cat([pred_target_lt, t_dirs], dim=1),
                              torch.cat([reference_lt, r_dirs], dim=1)], dim=0)

    # 6. noise + timesteps + add_noise
    noise = draw("noise", lambda: torch.randn(target_lt.shape, generator=generator,
                                              device=dev))
    timesteps = draw("timesteps", lambda: torch.randint(
        0, scheduler.config.num_train_timesteps, (B,), generator=generator,
        device=dev))
    noisy_latents = scheduler.add_noise(target_lt, noise, timesteps)

    # 7-8. U-Net prediction + diffusion loss
    noise_pred = sd_forward(params["sd"], noisy_latents, timesteps, image_embeds,
                            cfg.sd, compute_dtype=compute_dtype, pair_tokens=pair_tokens,
                            tp_axis=tp_axis)
    sd_loss = mse_loss(noise_pred.float(), noise)
    aux = {"pred_target_latent": pred_target, "weights_sum": out["weights_sum"],
           "noisy_latents": noisy_latents, "noise_pred": noise_pred}
    return sd_loss, nerf_loss, aux


def lr_factor(cfg: TrainConfig) -> Callable[[int], float]:
    """The lr multiplier after ``n`` optimizer updates: 1 for "constant";
    ``optax.exponential_decay(lr, lr_decay_steps, lr_decay_factor)`` (not
    staircase) or ``optax.cosine_decay_schedule(lr, lr_decay_steps,
    alpha=lr_decay_factor)`` divided by lr."""
    steps, factor = cfg.lr_decay_steps, cfg.lr_decay_factor
    if cfg.lr_schedule == "constant":
        return lambda n: 1.0
    if cfg.lr_schedule == "exponential":
        if steps <= 0 or factor == 0:       # optax's constant cases
            return lambda n: 1.0
        return lambda n: 1.0 if n <= 0 else factor ** (n / steps)
    if cfg.lr_schedule == "cosine":
        if not steps > 0:
            raise ValueError(f"the cosine lr schedule needs lr_decay_steps > 0, "
                             f"got {steps}")
        return lambda n: ((1 - factor) * 0.5 * (1 + math.cos(math.pi * min(n, steps)
                                                              / steps)) + factor)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                     "(constant | exponential | cosine)")


def make_optimizer(cfg: TrainConfig, params: Dict, mask: Dict) -> torch.optim.AdamW:
    """AdamW over the trainable leaves of ``params``.

    Sets ``requires_grad`` on the trainable leaves and clears it on the
    frozen ones.  ``cfg.nerf_lr`` gives the NeRF leaves a param group of
    their own.  Gradient accumulation is done by the train step; the lr
    schedule by :func:`make_lr_scheduler` on this optimizer."""
    lr_factor(cfg)                          # an unknown schedule raises here
    groups = {"sd": [], "nerf": []}
    for part in ("sd", "nerf"):
        for x, m in zip(tree_leaves(params[part]), tree_leaves(mask[part])):
            if x.is_floating_point():
                x.requires_grad_(bool(m))
            if m:
                groups[part].append(x)
    if cfg.nerf_lr is None:
        param_groups = [{"params": groups["sd"] + groups["nerf"]}]
    else:
        param_groups = [{"params": groups["sd"]},
                        {"params": groups["nerf"], "lr": cfg.nerf_lr}]
    return torch.optim.AdamW(param_groups, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                             eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def optimizer_param_paths(params: Dict, mask: Dict) -> List[str]:
    """The path (``tree_leaves_with_path``'s, from the root) of each
    parameter of :func:`make_optimizer`'s optimizer, in its order: the
    parameter indices of its state dict."""
    return [f"[{part!r}]{path}"
            for part in ("sd", "nerf")
            for (path, _), m in zip(tree_leaves_with_path(params[part]),
                                    tree_leaves(mask[part])) if m]


def make_lr_scheduler(cfg: TrainConfig,
                      optimizer: torch.optim.Optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    """``cfg.lr_schedule`` as a LambdaLR on ``optimizer``, counted in
    optimizer updates: the first update uses the factor at 0, and the train
    step advances it once per update (an accumulated step counts once),
    as optax counts its schedule."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(cfg))


def check_batch_device(batch: Dict, dev: torch.device) -> None:
    """A step built for one device refuses a batch on another."""
    if batch["target_image"].device.type != dev.type:
        raise ValueError(f"batch on {batch['target_image'].device}, step "
                         f"built for {dev}")


def make_train_step(cfg: JointConfig, scheduler: DDIMScheduler,
                    optimizer: torch.optim.Optimizer, *,
                    lr_scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    sample_budget: Optional[int] = None,
                    compute_dtype=torch.bfloat16, with_vis: bool = False,
                    device: Optional[torch.device] = None, mesh=None, fsdp=None,
                    tp_axis=None):
    """The joint train step: forward, backward into the trainable leaves,
    and an AdamW update every ``cfg.train.grad_accum_steps`` calls (the
    mean of the accumulated gradients, as optax.MultiSteps), after which
    ``lr_scheduler`` (from :func:`make_lr_scheduler`; required unless the
    schedule is constant) advances.

    Returns ``step(params, grid_state, batch, generator=None, draws=None)``
    → {"loss", "sd_loss", "nerf_loss"} as 0-d tensors; params update in
    place.  ``with_vis``: the step returns ``(metrics, {"latents": noisy
    latents, "pred": noise prediction})``, the tensors the reference dumps
    for inspection.  Runs on ``device`` (default cuda) and refuses a batch
    elsewhere.

    ``mesh`` (``parallel.make_mesh``): the step of one data-parallel rank
    (the JAX step's ``pmean_axis``).  At each update every trainable
    gradient, the NeRF's included, is averaged over the ranks, and each
    call's three losses are too.  ``fsdp`` (``parallel.place_joint_for_fsdp``'s
    layout, over ``params`` as it returned them): the step gathers the
    sharded leaves for use and reduce-scatters their gradients to the
    slices; the other gradients are averaged as under ``mesh``.  It computes
    the global batch's step, as the JAX package's GSPMD step does: the ip
    tokens are paired over the global batch (``embed_conditions``).
    ``tp_axis`` (``parallel.tp.place_joint_for_tp``'s axis, ``params`` its
    tree): the U-Net runs tensor-parallel, every rank of the model axis on
    the same rows and draws; ``mesh`` is then the data axis, over which
    alone the gradients are averaged (the replicated leaves' gradients
    agree across the model axis already).  Like the JAX package's GSPMD
    step it computes the global batch's step: the ip tokens are paired over
    the global batch.
    """
    dev = resolve_device(device)
    if lr_scheduler is None and cfg.train.lr_schedule != "constant":
        raise ValueError(f"lr_schedule {cfg.train.lr_schedule!r} needs the "
                         "lr_scheduler of make_lr_scheduler")
    pair_tokens = None
    if fsdp is not None:
        mesh = fsdp.mesh
    if tp_axis is not None and mesh is not None and mesh.world == 1:
        mesh = None                 # tensor parallelism alone: nothing to average
    if (fsdp is not None or tp_axis is not None) and mesh is not None and mesh.world > 1:
        pair_tokens = global_token_pairing(mesh)
    accum = cfg.train.grad_accum_steps
    calls = [0]

    def step(params, grid_state, batch, generator=None, draws=None):
        check_batch_device(batch, dev)
        used = fsdp.gather(params) if fsdp is not None else params
        sd_loss, nerf_loss, aux = forward_iteration(
            used, grid_state, batch, cfg, scheduler, train=True,
            compute_dtype=compute_dtype, sample_budget=sample_budget,
            generator=generator, draws=draws, pair_tokens=pair_tokens, tp_axis=tp_axis)
        total = sd_loss + nerf_loss
        total.backward()
        if fsdp is not None:
            fsdp.reduce_scatter_grads(used, params)
        del used
        calls[0] += 1
        if calls[0] % accum == 0:
            with_grad = [p for group in optimizer.param_groups for p in group["params"]
                         if p.grad is not None]
            if mesh is not None:
                # the slices' gradients are averaged already
                all_reduce_mean_([p.grad for p in with_grad
                                  if fsdp is None or not fsdp.is_shard(p)], mesh)
            if accum > 1:
                for p in with_grad:
                    p.grad.div_(accum)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if lr_scheduler is not None:
                lr_scheduler.step()
        losses = torch.stack([total.detach(), sd_loss.detach(), nerf_loss.detach()])
        if mesh is not None:
            all_reduce_mean_([losses], mesh)
        metrics = dict(zip(("loss", "sd_loss", "nerf_loss"), losses.unbind()))
        if with_vis:
            return metrics, {"latents": aux["noisy_latents"].detach(),
                             "pred": aux["noise_pred"].detach()}
        return metrics

    return step


def make_eval_step(cfg: JointConfig, scheduler: DDIMScheduler,
                   sample_budget: Optional[int] = None, *,
                   compute_dtype=torch.bfloat16,
                   device: Optional[torch.device] = None, tp_axis=None):
    """Validation forward, no grad; ``tp_axis`` as in :func:`make_train_step`.

    ``sample_budget``: explicit eval render budget (e.g. the one from
    :func:`eval_budget_for_occupancy`); None → the static eval default.
    Returns ``step(params, grid_state, batch, generator=None, draws=None)``
    → {"loss", "sd_loss", "nerf_loss"}.  Runs on ``device`` (default cuda)."""
    dev = resolve_device(device)

    def step(params, grid_state, batch, generator=None, draws=None):
        check_batch_device(batch, dev)
        with torch.no_grad():
            sd_loss, nerf_loss, _ = forward_iteration(
                params, grid_state, batch, cfg, scheduler, train=False,
                compute_dtype=compute_dtype, sample_budget=sample_budget,
                generator=generator, draws=draws, tp_axis=tp_axis)
        return {"loss": sd_loss + nerf_loss, "sd_loss": sd_loss,
                "nerf_loss": nerf_loss}

    return step
