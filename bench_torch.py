#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port (stable_nerf_tpu_torch) on one
NVIDIA GPU: the counterpart of bench.py, with its metric names and method.

    python bench_torch.py

Prints the CUMULATIVE result as one JSON line on stdout after every
metric (progress goes to stderr), so the last stdout line is always the
most complete record: a time limit that cuts the run shortens the metric
set instead of erasing it.  A wall-clock budget (``BENCH_BUDGET_S``,
default 1500 s) skips a metric that no longer fits and records why; a
metric that fails records its error; either way the run goes on.
Metrics, in bench.py's order of priority:

  * ``nerf_train_rays_per_sec`` (the headline): rays/s through the
    occupancy-grid NeRF train path (march → hash encode → MLPs →
    composite → backward) at 2 poses × 64² = 8,192 latent rays, 256 march
    steps, the 128³ grid marked and refreshed once, a sample budget of
    2^18, bf16 compute; the hash-table gradient scatter kernel
    (csrc/hash_scatter.cu) runs in every backward (its launches a step go
    to stderr); ``_stochastic`` with the one-corner encode;
  * ``joint_step_full_sdxl_ms``: the full-SDXL joint train step
    (scripts/bench_torch_joint_full_sdxl.py, a child process);
  * ``nerf_eval_ms_per_image`` (4,096 rays, 512 march steps, budget
    64·4,096) and ``_auto`` (the occupancy-driven budget of
    ``eval_budget_for_occupancy`` at the committed synthetic scene's
    analytic occupancy);
  * ``sd_denoise_steps_per_sec`` / ``_ms_per_step`` / ``_mfu``: the full
    SDXL U-Net with IP heads, params in bf16, batch 2, 64² latents, a
    10-step DDIM loop; the MFU's numerator is the analytic count of
    utils/flops.py, its denominator the card's dense bf16 peak;
    ``sd_denoise_gflops_per_step_counted`` is
    ``torch.utils.flop_counter.FlopCounterMode`` over one untimed forward;
    the same at batches 4 and 8 (``_b4``, ``_b8``);
  * ``joint_step_ms``: the joint train step with the tiny SD and the full
    NeRF (8,192 rays, 256 steps, budget 2^18, all-occupied grid), and
    ``_stochastic``.

Timing is the best of 3 blocks, each ending in ``torch.cuda.synchronize``.

Where this differs from bench.py:
  (a) there is no backend probe: without a CUDA device ``main`` prints one
      record with ``"error"`` and exits non-zero; nothing runs on the CPU;
  (b) ``vs_baseline`` is the ratio to a card record of this benchmark's
      own (``BENCH_torch_baseline.json``, where one is committed), never to
      the TPU's ``BENCH_baseline.json``; without one it is null;
  (c) the merged records are the port's own: ``BATCH_SWEEP_torch.json``,
      ``HYBRID_SWEEP_torch.json`` and the port's demo workdir
      ``output_port_demo/metrics.jsonl``; never the TPU's
      ``BATCH_SWEEP.json``, ``HYBRID_SWEEP.json`` or ``runs/``.
There is no compile cache to warm: the port runs eagerly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE = "BENCH_torch_baseline.json"
BATCH_SWEEP = "BATCH_SWEEP_torch.json"
HYBRID_SWEEP = "HYBRID_SWEEP_torch.json"
DEMO_METRICS = os.path.join("output_port_demo", "metrics.jsonl")
# the JAX package's TPU records: the port's sweeps never write them
TPU_RECORDS = ("BATCH_SWEEP.json", "HYBRID_SWEEP.json")

# dense (no sparsity) bf16 tensor-core peaks by torch.cuda.get_device_name,
# from NVIDIA's H100 data sheet; an unknown card gets no MFU
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,      # SXM5: half the 1,979 quoted with sparsity
    "NVIDIA H100 PCIe": 756.5e12,
    "NVIDIA H100 NVL": 835.5e12,
}

NERF_INTRINSICS = (138.0, 138.0, 32, 32)


def _sizes():
    """(NeRFConfig, UNetConfig, latent side) that the bench measures: the
    flagship NeRF (channel 4) and SDXL's U-Net at 64² latents.  The card
    tests patch this one hook to run the bench functions at a small
    size."""
    from stable_nerf_tpu_torch.config import NeRFConfig
    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config

    return NeRFConfig(channel_dim=4), sdxl_unet_config(), 64


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def refuse_tpu_record(path: str) -> None:
    """Raise SystemExit when ``path`` names one of the TPU's records
    (``BATCH_SWEEP.json``, ``HYBRID_SWEEP.json``): the port's sweeps write
    their own ``*_torch.json``."""
    if os.path.basename(path) in TPU_RECORDS:
        raise SystemExit(f"refusing to write {path}: {os.path.basename(path)} is the "
                         "JAX package's TPU record; the port writes *_torch.json")


def _sync():
    import torch

    torch.cuda.synchronize()


def best_of_blocks(fn, n_blocks=3, n_iters=10, sync=None):
    """Steady-state seconds an iteration, the best of ``n_blocks`` blocks
    of ``n_iters`` calls ``fn(i)``, each block ending in ``sync()`` (by
    default a synchronize of the card)."""
    sync = sync or _sync
    best = float("inf")
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        for i in range(n_iters):
            fn(i)
        sync()
        best = min(best, (time.perf_counter() - t0) / n_iters)
    return best


def best_ms(fn, device, n_iters=10, n_blocks=3) -> float:
    """Steady-state ms a call of ``fn()`` on ``device``: one warm-up call,
    then :func:`best_of_blocks`, each block ending in a synchronize of the
    card (the host clock alone on the CPU, which measures PyTorch's CPU
    kernels, not a device).  The port's study scripts time eagerly with
    it."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    return best_of_blocks(lambda i: fn(), n_blocks, n_iters, sync) * 1e3


def device_line(device) -> str:
    """What the times were taken on: ``nvidia-smi``'s name and power limit
    of the card, or a note that a CPU run's times are the host's."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu (host clock: PyTorch's CPU kernels, no device time)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def _card():
    """The CUDA device, with TF32 off; raises without one."""
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device

    disable_tf32()
    return resolve_device()


def _refreshed_grid(params, cfg, poses, dev, g):
    """The occupancy grid marked from ``poses`` and refreshed once."""
    from stable_nerf_tpu_torch.models.nerf.grid import (grid_init, mark_untrained_grid,
                                                        update_extra_state)
    from stable_nerf_tpu_torch.models.nerf.network import nerf_density

    state = mark_untrained_grid(grid_init(cfg, device=dev), poses, NERF_INTRINSICS, cfg)
    state = update_extra_state(state, lambda x: nerf_density(params, x, cfg)["sigma"],
                               cfg, generator=g)
    _sync()
    return state


def bench_nerf_render(stochastic: bool = False):
    """(rays/s, s a step, K1 launches a step) of the NeRF train render,
    forward and backward into every NeRF param."""
    import torch

    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.models.nerf.renderer import render
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(_sizes()[0], hash_stochastic=stochastic)
    params = nerf_init(0, cfg, device=dev)
    poses = rand_poses(g, 2, radius=2.0)
    rays = get_rays(poses, NERF_INTRINSICS, 64, 64)
    state = _refreshed_grid(params, cfg, poses, dev, g)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    o, d = rays["rays_o"], rays["rays_d"]
    n_rays = o.shape[0] * o.shape[1]
    budget = 2 ** 18    # ~32 samples a ray on average: a trained scene's regime

    def step(i):
        out = render(params, state, o, d, cfg, bg_color=1.0, max_steps=256,
                     perturb=torch.rand(n_rays, generator=g, device=dev),
                     compute_dtype=torch.bfloat16, sample_budget=budget)
        loss = (out["image"] - 0.5).abs().mean()
        return loss, torch.autograd.grad(loss, leaves)

    step(0)
    _sync()
    before = hash_scatter_add_per_level.launches
    step(0)
    launches = hash_scatter_add_per_level.launches - before
    dt = best_of_blocks(step)
    return n_rays / dt, dt, launches


def scene_spheres():
    """The committed synthetic scene's spheres in ngp space, (center,
    radius, rgb) each: ``SPHERES`` of scripts/make_torch_synthetic_scene.py,
    the port's one copy, loaded from its file."""
    import importlib.util

    path = os.path.join(HERE, "scripts", "make_torch_synthetic_scene.py")
    spec = importlib.util.spec_from_file_location("make_torch_synthetic_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPHERES


def _scene_occupancy_grid(cfg):
    """Occupancy of the committed synthetic three-sphere scene on the
    grid: the occupancy a converged fit reaches, computed analytically.
    A cell whose centre lies inside a sphere or within one cell diagonal
    of its surface counts occupied (the fit's dilation).  Returns a
    [1, H, H, H] bool array equal to bench.py's."""
    H = cfg.grid_size
    xs = ((np.arange(H) + 0.5) / H * 2.0 - 1.0) * cfg.bound
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    occ = np.zeros((H ** 3,), bool)
    dilate = 2.0 * cfg.bound / H * np.sqrt(3.0)
    for center, radius, _ in scene_spheres():
        occ |= np.linalg.norm(pts - center, axis=-1) <= radius + dilate
    return occ.reshape(1, H, H, H)


def bench_nerf_eval():
    """The eval render of one 64² latent image (4,096 rays, 512 march
    steps, no grad), (a) at the static 64-samples-a-ray budget and (b) at
    the occupancy-driven budget on the synthetic scene's grid.  Returns
    (static ms, auto ms, occupied fraction, auto budget)."""
    import torch

    from stable_nerf_tpu_torch.config import TrainConfig
    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.models.nerf.renderer import render
    from stable_nerf_tpu_torch.training.joint import eval_budget_for_occupancy

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = _sizes()[0]
    params = nerf_init(0, cfg, device=dev)
    poses = rand_poses(g, 1, radius=2.0)
    rays = get_rays(poses, NERF_INTRINSICS, 64, 64)
    state = _refreshed_grid(params, cfg, poses, dev, g)
    o, d = rays["rays_o"], rays["rays_d"]

    @torch.no_grad()
    def timed(state, budget):
        def eval_render(i):
            return render(params, state, o, d, cfg, bg_color=1.0, max_steps=512,
                          compute_dtype=torch.bfloat16, sample_budget=budget)

        eval_render(0)
        _sync()
        return best_of_blocks(eval_render) * 1e3

    static_ms = timed(state, 64 * 4096)     # sample_budget_eval_per_ray's default
    occ = _scene_occupancy_grid(cfg)
    scene_state = state._replace(occ=torch.from_numpy(occ).to(dev))
    occ_frac = float(occ.mean())
    auto_budget = eval_budget_for_occupancy(occ_frac, 4096, TrainConfig())
    auto_ms = timed(scene_state, auto_budget)
    return static_ms, auto_ms, occ_frac, auto_budget


def detect_peak_flops():
    """(device name, dense bf16 peak FLOP/s, or None for an unknown card)."""
    import torch

    kind = torch.cuda.get_device_name(0)
    return kind, PEAK_BF16_FLOPS.get(kind)


def sdxl_ddim_loop(params, cfg, batch: int, n_steps: int, device, pooled=None,
                   compute_dtype=None):
    """The SDXL denoise loop of this bench and of
    scripts/validate_torch_sdxl_checkpoint.py: ``unet_apply`` with zero IP
    tokens, the pooled embeds (zeros where None), the SDXL time ids at
    1024, ``n_steps`` eta-0 DDIM steps, compute in ``compute_dtype``
    (bf16 where None).  Returns (forward(x, t) → eps, denoise(x) → the
    latents after the loop, timesteps); both run without grad."""
    import torch

    from stable_nerf_tpu_torch.config import SchedulerConfig
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.unet import unet_apply

    dtype = compute_dtype or torch.bfloat16
    scheduler = DDIMScheduler.create(SchedulerConfig(), device=device)
    ip_tokens = torch.zeros((batch, 4, cfg.cross_attention_dim), dtype=dtype, device=device)
    if pooled is None:
        pooled = torch.zeros((batch, cfg.pooled_projection_dim), device=device)
    time_ids = torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]],
                            device=device).expand(batch, 6)
    ts = torch.as_tensor(scheduler.timesteps(n_steps), device=device)

    @torch.no_grad()
    def forward(x, t):
        return unet_apply(params, x, t, ip_tokens, added_text_embeds=pooled,
                          added_time_ids=time_ids, cfg=cfg, compute_dtype=dtype)

    @torch.no_grad()
    def denoise(x):
        for t in ts:
            x, _ = scheduler.step(forward(x, t), t, x, num_inference_steps=n_steps)
        return x

    return forward, denoise, ts


def build_sd_denoise(n_steps: int = 10, batch: int = 2):
    """The denoise workload of ``bench_sd_denoise``: the full SDXL U-Net
    with IP heads from seed 0, params in bf16, ``sdxl_ddim_loop`` with
    zero pooled embeds, start latents [batch, 4, 64, 64].  Returns (cfg,
    forward(x, t) → eps, denoise(i) → latents after the loop, start
    latents, timesteps)."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.unet import unet_init
    from stable_nerf_tpu_torch.utils.tree import tree_map

    dev = _card()
    _, cfg, H = _sizes()
    g = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                      unet_init(g, cfg, with_ip=True))
    latents0 = torch.randn((batch, 4, H, H), generator=g, device=dev)
    forward, loop, ts = sdxl_ddim_loop(params, cfg, batch, n_steps, dev)
    return cfg, forward, (lambda i: loop(latents0)), latents0, ts


def bench_sd_denoise(n_steps: int = 10, batch: int = 2):
    """The full SDXL U-Net with IP heads: a ``n_steps`` DDIM loop at 64²
    latents, params in bf16, bf16 compute.  ``batch`` 2 is the reference's
    inference batch; 4 and 8 measure the more-views-a-card lever.

    Returns (steps/s, ms a step, MFU or None, device name, peak or None,
    analytic FLOPs a step, FlopCounterMode FLOPs of one forward,
    (memory kind, GiB)).  The memory is the allocator's peak from the
    params' build on (the build's float32 transient excluded)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from stable_nerf_tpu_torch.utils.flops import unet_forward_flops
    from stable_nerf_tpu_torch.utils.profiling import measured_hbm_gb

    cfg, forward, denoise, latents0, ts = build_sd_denoise(n_steps, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    denoise(0)
    _sync()
    # MFU numerator: the analytic count; FlopCounterMode's count of one
    # forward is recorded beside it for the audit trail
    flops_per_step = float(unet_forward_flops(cfg, batch, latents0.shape[-1]))
    with FlopCounterMode(display=False) as counter:
        forward(latents0, ts[0])
    flops_counted = float(counter.get_total_flops())

    dt_step = best_of_blocks(denoise, n_blocks=3, n_iters=2) / n_steps
    kind, peak = detect_peak_flops()
    mfu = flops_per_step / dt_step / peak if peak else None
    return (1.0 / dt_step, dt_step * 1e3, mfu, kind, peak, flops_per_step,
            flops_counted, measured_hbm_gb())


def bench_joint_step(stochastic: bool = False):
    """ms of the joint train step (full NeRF, tiny SD, AdamW) at 1 sample
    × 2 views × 64² latent rays = 8,192 rays, 256 march steps, a 2^18
    sample budget, an all-occupied grid; ``stochastic``: the one-corner
    hash encode."""
    import torch

    from stable_nerf_tpu_torch.config import NeRFConfig, SDConfig, TrainConfig
    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import (SDNetworkConfig,
                                                                   sd_network_init)
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.training.joint import (JointConfig, joint_trainable_mask,
                                                      make_optimizer, make_train_step)

    dev = _card()
    cfg = JointConfig(
        nerf=NeRFConfig(channel_dim=4, hash_stochastic=stochastic),
        sd=SDNetworkConfig(
            sd=SDConfig(latent_size=64, image_size=128, cross_attention_dim=48),
            unet=tiny_unet_config(),
            vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                          norm_groups=8)),
        train=TrainConfig(max_steps_train=256, sample_budget=2 ** 18),
    )
    params = {"sd": sd_network_init(0, cfg.sd, device=dev),
              "nerf": nerf_init(1, cfg.nerf, device=dev)}
    grid = grid_init(cfg.nerf, device=dev)
    grid = grid._replace(occ=torch.ones_like(grid.occ))
    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    opt = make_optimizer(cfg.train, params, joint_trainable_mask(params))
    step = make_train_step(cfg, scheduler, opt, sample_budget=cfg.train.sample_budget,
                           device=dev)

    B, enc, img = 1, 64, 128
    g = torch.Generator(device=dev).manual_seed(0)
    intr = (float(enc), float(enc), enc / 2, enc / 2)
    rt = get_rays(rand_poses(g, B, radius=2.0), intr, enc, enc)
    rr = get_rays(rand_poses(g, B, radius=2.0), intr, enc, enc)
    # bench.py draws both images from one key: the same image twice
    image = torch.rand((B, 3, img, img), generator=g, device=dev) * 2 - 1
    batch = {"target_image": image, "reference_image": image.clone(),
             "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
             "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"]}

    def run(i):
        return step(params, grid, batch, generator=g)

    run(0)
    _sync()
    before = hash_scatter_add_per_level.launches
    run(0)
    log(f"  scatter kernel launches a joint step: "
        f"{hash_scatter_add_per_level.launches - before}")
    return best_of_blocks(run, n_blocks=3, n_iters=5) * 1e3


def bench_joint_full_sdxl(timeout_s: int = 2400):
    """The full-SDXL joint train step (scripts/bench_torch_joint_full_sdxl.py)
    in a child process of its own, so that its ~18 GB of state leaves this
    process's allocator alone.  Returns the script's result dict."""
    script = os.path.join(HERE, "scripts", "bench_torch_joint_full_sdxl.py")
    proc = subprocess.run([sys.executable, script, "--iters", "3"],
                          capture_output=True, text=True, timeout=timeout_s)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_torch_joint_full_sdxl rc={proc.returncode}: "
                           f"{proc.stderr[-500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    t_start = time.monotonic()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1500"))

    def remaining():
        return budget_s - (time.monotonic() - t_start)

    result = {
        "metric": "nerf_train_rays_per_sec",
        "value": 0.0,
        "unit": "rays/s (fwd+bwd, 8192 rays x 256 steps, 128^3 grid, bf16)",
        "vs_baseline": None,
    }

    def emit():
        """Print the cumulative record, one JSON object a line."""
        print(json.dumps(result), flush=True)

    import torch

    if not torch.cuda.is_available():
        result["error"] = ("no CUDA device: bench_torch.py measures the card "
                           "and does not run on the CPU")
        emit()
        return 1

    log("bench: NeRF train render…")
    rays_per_sec, _, launches = bench_nerf_render()
    log(f"  {rays_per_sec:.0f} rays/s; scatter kernel launches a step: {launches}")
    result["value"] = round(rays_per_sec, 1)
    baseline_path = os.path.join(HERE, BASELINE)
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            prev = json.load(f).get("value")
        if prev:
            result["vs_baseline"] = round(rays_per_sec / prev, 3)
    emit()

    def metric(name, min_budget_s, fn):
        """One metric with skip-and-record: too little budget left → record
        why; failure → record the error; success → fn stored its keys.
        Either way the cumulative line is printed again."""
        if remaining() < min_budget_s:
            log(f"bench: skipping {name} — {remaining():.0f}s left "
                f"< {min_budget_s}s needed")
            result[f"{name}_skipped"] = (
                f"insufficient budget ({remaining():.0f}s left)")
            emit()
            return
        try:
            log(f"bench: {name}…")
            fn()
        except Exception as e:   # a metric's failure is recorded, the run goes on
            log(f"  {name} failed: {e!r}")
            result[f"{name}_error"] = str(e)[:300]
        finally:
            torch.cuda.empty_cache()
        emit()

    def m_stochastic():
        fast_rps, _, fast_launches = bench_nerf_render(stochastic=True)
        result["nerf_train_rays_per_sec_stochastic"] = round(fast_rps, 1)
        log(f"  {fast_rps:.0f} rays/s; scatter kernel launches a step: {fast_launches}")

    def m_eval():
        eval_ms, eval_auto_ms, occ_frac, auto_budget = bench_nerf_eval()
        result["nerf_eval_ms_per_image"] = round(eval_ms, 2)
        result["nerf_eval_ms_per_image_auto"] = round(eval_auto_ms, 2)
        result["nerf_eval_auto_occ_frac"] = round(occ_frac, 4)
        result["nerf_eval_auto_budget"] = auto_budget
        log(f"  {eval_ms:.1f} ms/image static (4096 rays, 512 steps); "
            f"{eval_auto_ms:.1f} ms/image occupancy-driven "
            f"(occ={occ_frac:.3f}, budget={auto_budget})")

    def m_denoise():
        (sps, ms, mfu, kind, peak, flops, flops_counted,
         peak_hbm) = bench_sd_denoise()
        result["sd_denoise_steps_per_sec"] = round(sps, 2)
        result["sd_denoise_ms_per_step"] = round(ms, 2)
        result["device_kind"] = kind
        if peak:
            result["peak_bf16_tflops_assumed"] = round(peak / 1e12, 1)
        result["sd_denoise_gflops_per_step"] = round(flops / 1e9, 1)
        result["sd_denoise_flops_basis"] = "analytic (utils/flops.py)"
        result["sd_denoise_gflops_per_step_counted"] = round(flops_counted / 1e9, 1)
        if mfu is not None:
            result["sd_denoise_mfu"] = round(mfu, 4)
        hkind, hgb = peak_hbm
        result["sd_denoise_hbm_gb"] = round(hgb, 2)
        result["sd_denoise_hbm_measure"] = hkind
        log(f"  {ms:.1f} ms/step ({sps:.1f} steps/s, "
            f"mfu={result.get('sd_denoise_mfu')} on {kind})")

    def m_denoise_batch(b):
        def run():
            (_, ms, mfu, _, _, _, _, peak_hbm) = bench_sd_denoise(batch=b)
            result[f"sd_denoise_ms_per_step_b{b}"] = round(ms, 2)
            if mfu is not None:
                result[f"sd_denoise_mfu_b{b}"] = round(mfu, 4)
            result[f"sd_denoise_hbm_gb_b{b}"] = round(peak_hbm[1], 2)
            result[f"sd_denoise_hbm_measure_b{b}"] = peak_hbm[0]
            log(f"  batch {b}: {ms:.1f} ms/step mfu={mfu and round(mfu, 4)}")
        return run

    def m_joint():
        joint_ms = bench_joint_step()
        result["joint_step_ms"] = round(joint_ms, 1)
        result["joint_rays_per_sec"] = round(8192 / (joint_ms / 1e3), 1)
        log(f"  {joint_ms:.0f} ms ({result['joint_rays_per_sec']:.0f} rays/s)")

    def m_joint_stochastic():
        joint_fast_ms = bench_joint_step(stochastic=True)
        result["joint_step_ms_stochastic"] = round(joint_fast_ms, 1)
        log(f"  {joint_fast_ms:.0f} ms")

    def m_full_sdxl():
        # the child's time limit is what is left, so that a cut never
        # erases the metrics already printed
        t = int(max(60, min(2400, remaining() - 60)))
        try:
            full = bench_joint_full_sdxl(timeout_s=t)
        except subprocess.TimeoutExpired:
            result["joint_full_sdxl_skipped"] = f"child process exceeded {t}s"
            log(f"  full-SDXL child timed out at {t}s — recorded skip")
            return
        result["joint_step_full_sdxl_ms"] = full["joint_step_full_sdxl_ms"]
        result["joint_full_sdxl_fits_one_chip_no_remat"] = True
        log(f"  {full['joint_step_full_sdxl_ms']:.0f} ms "
            f"(peak {full.get('hbm_gb')} GiB, no remat)")

    def m_batch_sweep_file():
        # the sweeps run apart (scripts/bench_torch_{batch,hybrid}_sweep.py,
        # a child process a point); their records are folded in here
        path = os.path.join(HERE, BATCH_SWEEP)
        if os.path.exists(path):
            with open(path) as f:
                result["joint_batch_sweep"] = json.load(f)
            log(f"  merged {BATCH_SWEEP}")
        hpath = os.path.join(HERE, HYBRID_SWEEP)
        if os.path.exists(hpath):
            with open(hpath) as f:
                sweep = json.load(f)
            result["joint_hybrid_sweep"] = sweep
            for row in sweep.get("rows", []):
                if (row.get("mode") == "hybrid_min_level_8"
                        and "joint_step_ms" in row):
                    result["joint_step_ms_hybrid"] = row["joint_step_ms"]
            log(f"  merged {HYBRID_SWEEP}")
        # the port's learned-diffusion demo run: its last interleaved
        # inference record
        dpath = os.path.join(HERE, DEMO_METRICS)
        if os.path.exists(dpath):
            try:
                with open(dpath) as f:
                    inf = [json.loads(line) for line in f if '"inference"' in line]
                if inf:
                    result["learned_demo_denoised_psnr_db"] = round(
                        inf[-1]["inference_psnr"], 2)
                    result["learned_demo_epoch"] = inf[-1]["epoch"]
                    log(f"  learned demo: denoised PSNR "
                        f"{inf[-1]['inference_psnr']:.2f} dB (epoch {inf[-1]['epoch']})")
            except (ValueError, KeyError) as e:
                result["learned_demo_error"] = str(e)

    # bench.py's order: the full-SDXL step right after the first metric and
    # the file merge, so that a tight limit cuts the batch extras at the end
    metric("nerf_stochastic", 60, m_stochastic)
    metric("batch_sweep_record", 0, m_batch_sweep_file)
    metric("joint_full_sdxl", 150, m_full_sdxl)
    metric("nerf_eval", 90, m_eval)
    metric("sd_denoise", 120, m_denoise)
    metric("joint_step", 120, m_joint)
    metric("joint_step_stochastic", 60, m_joint_stochastic)
    metric("sd_denoise_b4", 120, m_denoise_batch(4))
    metric("sd_denoise_b8", 120, m_denoise_batch(8))
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
