#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stable_nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each printed as one JSON line; any failure exits non-zero:
  card         the card's name and power limit; the CUDA kernels built from
               stable_nerf_tpu_torch/csrc/ (build seconds, ptxas report);
  setup        random full-width weights and a batch of one scene: the SDXL
               U-Net and VAE, the 16-level 2^19 hash grid, 512² images,
               64² latents, 256 march steps, frozen weights stored in bf16;
  kernel_cases the hash-table gradient scatter kernel against its plain
               PyTorch version and a float64 ``index_add_``: (a) the main
               path's first backward chunk (the batch's own march
               positions), (a') the same shape at uniform positions, (b) a
               K2-shaped table, (c) a hot row plus padding, (d) payload_bf16;
  parity       the joint step at a tiny size on the card (kernel) against
               the same step on the CPU (plain versions), float32;
  joint_train  the full-width joint train step (bf16 compute) for a few
               steps, with the kernel launch count of those steps;
  profile      (with --profile DIR) one more step under torch.profiler:
               device time by kernel and the device's idle share, the full
               table written to DIR.
Then the ``kernels`` line, the ``nvidia-smi`` line, and last the device
line ``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks used for the roofline bound (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
JOINT_STEPS = 4          # the first is warm-up; the rest are timed
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scatter_case(name, idx, upd, n_levels, table_size, payload_bf16, reps):
    """Kernel vs plain version vs a float64 index_add_ on the same inputs.

    Tolerance: atomics sum each row in an order that changes from run to
    run; an f32 sum of a row's updates is held to 1e-5 of the row's sum of
    |updates| (per-row relative error against the float64 sum)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import (
        hash_scatter_add_per_level, hash_scatter_add_plain)

    total = n_levels * table_size
    F = upd.shape[-1]
    round_bf16 = payload_bf16 and F == 2
    out = hash_scatter_add_per_level(idx, upd, n_levels, table_size, payload_bf16)
    plain = hash_scatter_add_plain(idx, upd, total, round_bf16)
    torch.cuda.synchronize()

    u64 = upd.reshape(-1, F)
    u64 = (u64.to(torch.bfloat16) if round_bf16 else u64).double()
    flat = idx.reshape(-1).long()
    keep = (flat >= 0) & (flat < total)
    ref = torch.zeros((total, F), dtype=torch.float64, device=upd.device)
    ref.index_add_(0, flat[keep], u64[keep])
    rowabs = torch.zeros_like(ref).index_add_(0, flat[keep], u64[keep].abs())
    scale = rowabs.clamp_min(1e-30)

    def errs(x):
        d = (x.double() - ref).abs()
        return float(d.max()), float((d / scale).max())

    k_abs, k_rel = errs(out)
    p_abs, p_rel = errs(plain)
    kp_abs = float((out - plain).abs().max())
    kp_rel = float(((out - plain).abs().double() / scale).max())
    tol = 1e-5
    n = idx.numel()
    bytes_moved = n * (4 + 4 * F) + total * F * 4
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, n * F / F32_FLOPS) * 1e3
    row = {
        "case": name, "updates": n, "table_rows": total, "features": F,
        "payload_bf16": payload_bf16,
        "kernel_vs_f64_max_abs": k_abs, "kernel_vs_f64_max_rel": k_rel,
        "plain_vs_f64_max_abs": p_abs, "plain_vs_f64_max_rel": p_rel,
        "kernel_vs_plain_max_abs": kp_abs, "kernel_vs_plain_max_rel": kp_rel,
        "tolerance_rel_to_row_abs_sum": tol,
        "ms": cuda_ms(lambda: hash_scatter_add_per_level(
            idx, upd, n_levels, table_size, payload_bf16), reps),
        "plain_ms": cuda_ms(lambda: hash_scatter_add_plain(idx, upd, total,
                                                           round_bf16), reps),
        "bound_ms": bound_ms, "bound_by": "bytes",
    }
    if keep.all() and not round_bf16:     # one PyTorch call, a yardstick only
        u = upd.reshape(-1, F)
        row["library_ms"] = cuda_ms(lambda: torch.zeros(
            (total, F), device=upd.device).index_add_(0, flat, u), reps)
    else:
        row["library_ms"] = None
    row["ok"] = bool(k_rel <= tol and kp_rel <= 2 * tol and math.isfinite(k_abs))
    return row


def main_path_positions(cfg, batch, dev, g):
    """The normalized hash-encode positions [2^17, 3] of the first NeRF
    chunk of a train step on ``batch``: the dense lattice of the target
    and reference rays, jittered, clamped to the box (as the renderer
    marches them)."""
    import torch

    from stable_nerf_tpu_torch.ops.marching import march_rays_lattice
    from stable_nerf_tpu_torch.ops.ray_ops import near_far_from_aabb

    o = torch.cat([batch["target_rays_o"], batch["reference_rays_o"]]).reshape(-1, 3)
    d = torch.cat([batch["target_rays_d"], batch["reference_rays_d"]]).reshape(-1, 3)
    n, b = cfg.nerf, cfg.nerf.bound
    aabb = torch.tensor([-b, -b, -b, b, b, b], device=dev)
    nears, fars = near_far_from_aabb(o, d, aabb, n.min_near)
    occ = torch.ones((n.cascade,) + (n.grid_size,) * 3, dtype=torch.bool, device=dev)
    pos = march_rays_lattice(o, d, nears, fars, occ, bound=b, cascade=n.cascade,
                             grid_size=n.grid_size, max_steps=cfg.train.max_steps_train,
                             noise=torch.rand(o.shape[0], generator=g, device=dev))[0]
    return (pos.reshape(-1, 3)[: 2 ** 17] + b) / (2 * b)


def kernel_cases(dev, x_main):
    import torch

    from stable_nerf_tpu_torch.config import HashGridConfig
    from stable_nerf_tpu_torch.ops.encoding import _indices_weights_exact

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    # (a) the main path: one 131,072-sample chunk of the 16-level 2^19
    # grid, 8 corners → 16,777,216 updates into 16·2^19 rows; (a') the
    # same at uniform positions, which spread the updates over the rows
    cfg = HashGridConfig()
    M = x_main.shape[0]
    gout = torch.randn((M, cfg.n_levels, 1, 2), generator=g, device=dev)
    for name, x in (("a_main_path", x_main),
                    ("a_uniform_positions", torch.rand((M, 3), generator=g, device=dev))):
        rows, cw = _indices_weights_exact(x, cfg, 0, cfg.n_levels)
        upd = (cw[..., None] * gout).contiguous()
        cases.append(scatter_case(name, rows.to(torch.int32), upd, cfg.n_levels,
                                  cfg.table_size, False, reps=20))
        del rows, cw

    # (b) a K2-shaped table: L'·T = 3·1024 (a multiple of 1024, not 4096)
    L, T, Mb = 3, 1024, 100_000
    idx = (torch.randint(0, T, (Mb, L, 8), generator=g, device=dev)
           + torch.arange(L, device=dev)[None, :, None] * T).to(torch.int32)
    upd_b = torch.randn((Mb, L, 8, 2), generator=g, device=dev)
    cases.append(scatter_case("b_k2_table", idx.contiguous(), upd_b, L, T, False,
                              reps=20))

    # (c) one hot row plus padding rows >= T that must be dropped
    Mc = 1_000_000
    idx = torch.full((Mc, 1, 1), 77, dtype=torch.int32, device=dev)
    idx[-1000:] = 4096
    cases.append(scatter_case("c_hot_row_padding", idx,
                              torch.ones((Mc, 1, 1, 2), device=dev), 1, 4096,
                              False, reps=5))

    # (d) payload_bf16 on a quarter of the main-path chunk
    q = x_main[: M // 4]
    rows, cw = _indices_weights_exact(q, cfg, 0, cfg.n_levels)
    upd = (cw[..., None] * gout[: M // 4]).contiguous()
    cases.append(scatter_case("d_payload_bf16", rows.to(torch.int32), upd,
                              cfg.n_levels, cfg.table_size, True, reps=10))
    return cases


def tiny_joint_config():
    """The joint step at dry-run scale (the reference's _tiny_joint_setup)."""
    from stable_nerf_tpu_torch.config import (HashGridConfig, NeRFConfig, SDConfig,
                                              TrainConfig)
    from stable_nerf_tpu_torch.models.diffusion.sd_network import SDNetworkConfig
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig
    from stable_nerf_tpu_torch.training.joint import JointConfig

    return JointConfig(
        nerf=NeRFConfig(channel_dim=4, grid_size=32,
                        encoding_sigma=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                      base_resolution=4)),
        sd=SDNetworkConfig(
            sd=SDConfig(num_tokens=2, use_downsampling_layers=True,
                        cross_attention_dim=48, latent_size=16, image_size=32),
            unet=tiny_unet_config(),
            vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                          norm_groups=8)),
        train=TrainConfig(max_steps_train=32, max_steps_eval=64))


def make_setup(cfg, dev, seed):
    """Params, grid (all occupied), scheduler and a batch of one scene."""
    import torch

    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import (
        init_ip_from_unet, sd_network_init)
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.training.joint import cast_frozen, joint_trainable_mask

    params = {"sd": init_ip_from_unet(sd_network_init(seed, cfg.sd, device=dev)),
              "nerf": nerf_init(seed + 1, cfg.nerf, device=dev)}
    mask = joint_trainable_mask(params, cfg.train.trainable_scope)
    params = cast_frozen(params, mask, cfg.train.frozen_dtype)
    grid = grid_init(cfg.nerf, device=dev)
    grid = grid._replace(occ=torch.ones_like(grid.occ))
    scheduler = DDIMScheduler.create(cfg.sd.scheduler, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    enc, img = cfg.latent_hw, cfg.sd.sd.image_size
    intr = (float(enc), float(enc), enc / 2, enc / 2)
    rt = get_rays(rand_poses(g, 1, radius=2.0), intr, enc, enc)
    rr = get_rays(rand_poses(g, 1, radius=2.0), intr, enc, enc)
    batch = {
        "target_image": torch.rand((1, 3, img, img), generator=g, device=dev) * 2 - 1,
        "reference_image": torch.rand((1, 3, img, img), generator=g, device=dev) * 2 - 1,
        "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
        "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"],
    }
    return params, mask, grid, scheduler, batch


def parity_small(dev):
    """Tiny joint forward + backward on ``dev`` against the CPU port (plain
    versions), float32, same params and draws: losses and the hash-table
    gradient within 1e-4 relative."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
    from stable_nerf_tpu_torch.training.joint import forward_iteration
    from stable_nerf_tpu_torch.utils.tree import tree_map

    cfg = tiny_joint_config()
    cpu = torch.device("cpu")
    params, _, grid, _, batch = make_setup(cfg, cpu, SEED)
    g = torch.Generator().manual_seed(SEED + 3)
    enc = cfg.latent_hw
    draws = {"vae_eps": torch.randn((2, 4, enc, enc), generator=g),
             "noise": torch.randn((1, 4, enc, enc), generator=g),
             "timesteps": torch.tensor([417]),
             "perturb": torch.rand((2 * enc * enc,), generator=g)}
    results = {}
    for d in (cpu, dev):
        p = tree_map(lambda x: x.detach().to(d), params)
        table = p["nerf"]["hash"]["table"].requires_grad_(True)
        s, n, _ = forward_iteration(
            p, OccupancyGridState(*(t.to(d) for t in grid)),
            {k: v.to(d) for k, v in batch.items()}, cfg,
            DDIMScheduler.create(cfg.sd.scheduler, device=d),
            compute_dtype=torch.float32, draws={k: v.to(d) for k, v in draws.items()})
        (s + n).backward()
        results[d.type] = (s.item(), n.item(), table.grad.cpu())
    sc, nc, gc = results["cpu"]
    sg, ng, gg = results[dev.type]
    grad_err = float((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30))
    row = {"phase": "parity", "sd_loss": [sc, sg], "nerf_loss": [nc, ng],
           "sd_rel_err": abs(sg - sc) / abs(sc), "nerf_rel_err": abs(ng - nc) / abs(nc),
           "table_grad_rel_err": grad_err, "tolerance": 1e-4}
    row["ok"] = bool(row["sd_rel_err"] <= 1e-4 and row["nerf_rel_err"] <= 1e-4
                     and grad_err <= 1e-4)
    return row


def joint_full(dev, cfg, setup, steps):
    """Full-width train steps; returns the phase row and the step (launch
    count read right after the steps)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.training.joint import make_optimizer, make_train_step

    params, mask, grid, sched, batch = setup
    opt = make_optimizer(cfg.train, params, mask)
    step = make_train_step(cfg, sched, opt, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    losses, times = [], []
    hash_scatter_add_per_level.launches = 0
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    launches = hash_scatter_add_per_level.launches

    n_rays = 2 * cfg.latent_hw ** 2
    samples = n_rays * cfg.train.max_steps_train
    chunks = samples // 2 ** 17 if samples > 2 ** 17 and samples % 2 ** 17 == 0 else 1
    finite = all(math.isfinite(v) for l in losses for v in l.values())
    row = {
        "phase": "joint_train", "steps": steps, "samples_per_step": samples,
        "scatter_launches": launches, "expected_launches": chunks * steps,
        "step_ms": times, "steady_step_ms": statistics.median(times[1:]),
        "losses": losses,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
    }
    row["ok"] = bool(finite and launches == chunks * steps)
    return row, (step, params, grid, batch, g)


def profile_step(state, out_dir):
    """One more train step under torch.profiler: device time by kernel name,
    the busy share of the step's wall time, and the full table in out_dir."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, params, grid, batch, g = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    # device events named like a host op are annotations (e.g. the
    # optimizer's range), not kernels
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    by_name, spans = {}, []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in host_names:
            continue
        us = e.time_range.elapsed_us()
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + us, count + 1)
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    table = sorted(([n, t / 1e3, c] for n, (t, c) in by_name.items()),
                   key=lambda r: -r[1])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "joint_step_kernels.json"), "w") as f:
        json.dump({"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
                   "launches": len(spans), "kernels_ms_count": table}, f, indent=1)
    return {"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "kernel_ms_sum": sum(r[1] for r in table), "launches": len(spans),
            "top": [[n[:90], ms, c] for n, ms, c in table[:12]],
            "table": os.path.join(out_dir, "joint_step_kernels.json")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one more train step and write the table to DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stable_nerf_tpu_torch.config import NeRFConfig, TrainConfig
    from stable_nerf_tpu_torch.models.diffusion.sd_network import SDNetworkConfig
    from stable_nerf_tpu_torch.ops.hopper import build
    from stable_nerf_tpu_torch.training.joint import JointConfig
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    disable_tf32()
    dev = resolve_device()
    smi = nvidia_smi()
    t = time.perf_counter()
    reports = build.build(build.kernel_sources())
    build_s = time.perf_counter() - t
    for name, log in reports.items():
        print(f"ptxas report for csrc/{name}.cu:\n{log}", file=sys.stderr)
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "kernels_built": sorted(reports),
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})

    cfg = JointConfig(nerf=NeRFConfig(channel_dim=4), sd=SDNetworkConfig(),
                      train=TrainConfig(frozen_dtype="bfloat16", max_steps_train=256,
                                        trainable_scope="reference"))
    t = time.perf_counter()
    setup = make_setup(cfg, dev, SEED)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(setup[0]))})

    x_main = main_path_positions(cfg, setup[4], dev,
                                 torch.Generator(device=dev).manual_seed(SEED + 5))
    cases = kernel_cases(dev, x_main)
    emit({"phase": "kernel_cases", "cases": cases})
    del x_main
    parity = parity_small(dev)
    emit(parity)
    joint, state = joint_full(dev, cfg, setup, JOINT_STEPS)
    emit(joint)
    if args.profile:
        emit(profile_step(state, args.profile))

    a = cases[0]
    emit({"kernels": [{
        "name": "hash_scatter_add", "route": "cuda",
        "source": "stable_nerf_tpu_torch/csrc/hash_scatter.cu",
        "replaces": "stable_nerf_tpu/ops/pallas/scatter_v2.py:125",
        "also_replaces": "stable_nerf_tpu/ops/pallas/scatter.py:113",
        "launches": joint["scatter_launches"],
        "max_abs_err": a["kernel_vs_plain_max_abs"],
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
    }]})
    print(smi, flush=True)
    failed = [c["case"] for c in cases if not c["ok"]]
    if failed or not parity["ok"] or not joint["ok"]:
        print(f"chip_smoke: failed: cases {failed}, parity ok {parity['ok']}, "
              f"joint ok {joint['ok']}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
