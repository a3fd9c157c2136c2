#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stable_nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each printed as one JSON line; any failure exits non-zero:
  card         the card's name and power limit; the CUDA kernels built from
               stable_nerf_tpu_torch/csrc/ (both sources compiled at once;
               build seconds, ptxas report);
  setup        random full-width weights and a batch of one scene: the SDXL
               U-Net and VAE, the 16-level 2^19 hash grid, 512² images,
               64² latents, 256 march steps, frozen weights stored in bf16;
  kernel_cases the hash-table gradient scatter kernel against its plain
               PyTorch version and a float64 ``index_add_``: (a) the main
               path's first backward chunk (the batch's own march
               positions), (a') the same shape at uniform positions, (b) a
               K2-shaped table, (c) a hot row plus padding, (d) payload_bf16,
               (e) the chunks of a and a' one level at a time, with each
               level's rows, distinct rows and atomics left after merging,
               (f) a stochastic section [2^17, 8, 1], (g) rows outside their
               level's slab, negative and padding rows, (h) an odd M and T;
               each with the zero fill's time apart;
  gather_cases the sorted row-gather kernel against its plain version, bit
               for bit: (a) the sorted-encode floor shape (33,554,432 sorted
               items, 16·2^19 rows, f32), (b) the reference tests' three
               shapes, (c) padding and negative indices at an odd length,
               (d) a bf16 table, (e) unsorted indices, (f) a width of 4,
               (g) NaN, Inf and denormal entries;
  encode_floor the sorted-encode floor path (scripts/
               bench_torch_fused_render_floor.py::measure) at 2^18 samples:
               its stage times, its own equality check, the gather launches;
  parity       the joint step at a tiny size on the card (kernel) against
               the same step on the CPU (plain versions), float32;
  serve_parity the inference step at a tiny size (5 DDIM steps, float32) on
               the card against the CPU, every result key;
  joint_train  the full-width joint train step (bf16 compute) for a few
               steps, with the kernel launch count of those steps;
  joint_train_budget  two more steps with sample_budget 262,144 (compaction
               under gradient): 2 scatter launches a step, peak memory;
  serve        the full-width inference step (512 eval march steps, 64
               samples a ray, 50 DDIM steps, f32 VAE decode, metrics) for 3
               requests of 2 scenes each (the first is warm-up), split by
               stage, and one request at guidance_scale 3;
  profile      (with --profile DIR) one more train step and one more serving
               request under torch.profiler: device time by kernel and the
               device's idle share, the full tables written to DIR;
  train_loop   the training loop (training/loop.py::train) at the same full
               width over 10 scenes of datasets/nerf/synthetic_spheres.npz
               at 512² / 64²: 2 epochs (stochastic encode, then exact), each
               with its grid refresh, validation and trainable-only
               checkpoint, one inference request; a restore compared bit for
               bit with the state the run ended with; a resume to a third
               epoch.  Per epoch: steps, wall, refresh ms, occupied fraction,
               scatter launches (16 a dense exact step); checkpoint bytes and
               seconds, restore seconds, peak memory;
  cli          python -m stable_nerf_tpu_torch.train --tiny on the synthetic
               scene for one epoch, then --inference on its workdir.
Then the ``kernels`` line, the ``nvidia-smi`` line, and last the device
line ``{"ok": true, "device": {...}}``.  TF32 is off throughout.

    python3 chip_smoke.py --scatter-bench [--root DIR]

runs the card phase and the scatter cases only; with ``--root`` on the
package of another checkout unpacked below this script's directory (the
parent commit's, say), to compare two kernels on one card in one run of a
shell script.
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
JOINT_STEPS = 3          # the first is warm-up; the rest are timed
BUDGET_STEPS = 2
TRAIN_BUDGET = 262_144
SERVE_REQUESTS = 3       # the first is warm-up
SERVE_BATCH = 2
SEED = 0
SCATTER_RUN = 16         # kRun of csrc/hash_scatter.cu: samples a thread walks
LOOP_SCENES = 10         # scenes of the training loop's run: an 8 / 1 / 1 split


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up.
    ``queued``: the calls are enqueued while the device is still busy with
    ~2 ms of fills, so they run back to back there even where the host
    takes longer to enqueue a call than the device takes to run it (a
    wrapper's call costs the host 15-60 us)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        busy = torch.empty(2 ** 28, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    if queued:
        for _ in range(24):
            busy.zero_()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scatter_case(name, idx, upd, n_levels, table_size, payload_bf16, reps):
    """Kernel vs plain version vs a float64 index_add_ on the same inputs.

    Tolerance: the kernel sums a row in per-thread runs, per-block partial
    sums in shared memory and atomics whose order changes from run to run;
    whatever the grouping, an f32 sum of a row's updates is held to 1e-5 of
    the row's sum of |updates| (per-row relative error against the float64
    sum).  ``ms`` is the wrapper's call, its zero fill of the output
    included; ``zero_fill_ms`` is that fill alone.  Every time is taken
    the same way, on calls queued behind other work (``cuda_ms``)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import (
        hash_scatter_add_per_level, hash_scatter_add_plain)

    total = n_levels * table_size
    F = upd.shape[-1]
    round_bf16 = payload_bf16 and F == 2

    def kernel():
        return hash_scatter_add_per_level(idx, upd, n_levels, table_size, payload_bf16)

    out = kernel()
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
        "ms": cuda_ms(kernel, reps, queued=True),
        "zero_fill_ms": cuda_ms(lambda: torch.zeros(
            (total, F), dtype=torch.float32, device=upd.device), reps, queued=True),
        "plain_ms": cuda_ms(lambda: hash_scatter_add_plain(idx, upd, total, round_bf16),
                            reps, queued=True),
        "bound_ms": bound_ms, "bound_by": "bytes",
    }
    if keep.all() and not round_bf16:     # one PyTorch call, a yardstick only
        u = upd.reshape(-1, F)
        row["library_ms"] = cuda_ms(lambda: torch.zeros(
            (total, F), device=upd.device).index_add_(0, flat, u), reps, queued=True)
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


def merged_atomics(idx_level) -> int:
    """How many atomics the kernel's merging leaves of one level's [M, 8]
    rows: a pair of corners (c, c + 4) joins the run of the sample before
    it while both rows repeat (a run ends after SCATTER_RUN samples), and a
    run costs one atomic where its two rows share an aligned 16-byte slot,
    else two."""
    import torch

    lo, hi = idx_level[:, :4], idx_level[:, 4:]
    starts = torch.ones_like(lo, dtype=torch.bool)
    starts[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    starts[::SCATTER_RUN] = True
    paired = (lo ^ hi) == 1
    return int((starts & paired).sum() + 2 * (starts & ~paired).sum())


def per_level_breakdown(idx, upd, cfg, reps):
    """A [M, L, C] chunk one level at a time: L single-level calls on
    contiguous copies of ``idx[:, l:l+1]`` and ``upd[:, l:l+1]``, each
    timed as the wrapper's call less the zero fill of its output alone.
    The rows keep their offsets and the output its full size
    (``n_levels=L``), so every call finds the cache as the whole call's
    zero fill leaves it.  A single-level call starts a sixteenth of the
    whole call's blocks, so the times need not add up to the whole call's."""
    import torch

    from stable_nerf_tpu_torch.ops.encoding import _level_geometry
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level

    L, T = cfg.n_levels, cfg.table_size
    _, resolutions, dense = _level_geometry(cfg)
    fill = cuda_ms(lambda: torch.zeros((L * T, 2), device=upd.device), reps, queued=True)
    levels = []
    for l in range(L):
        i = idx[:, l:l + 1].contiguous()
        u = upd[:, l:l + 1].contiguous()
        ms = cuda_ms(lambda: hash_scatter_add_per_level(i, u, L, T), reps, queued=True)
        levels.append({"level": l, "resolution": resolutions[l], "dense": dense[l],
                       "rows": min(resolutions[l] ** 3, T),
                       "distinct_rows": int(torch.unique(i).numel()),
                       "atomics_after_merging": merged_atomics(idx[:, l]),
                       "call_ms": ms, "kernel_ms": ms - fill})
    return {"updates_per_level": idx[:, 0].numel(), "zero_fill_ms": fill,
            "levels": levels, "sum_kernel_ms": sum(r["kernel_ms"] for r in levels)}


def kernel_cases(dev, x_main):
    import torch

    from stable_nerf_tpu_torch.config import HashGridConfig
    from stable_nerf_tpu_torch.ops.encoding import (_indices_weights_exact,
                                                    _indices_weights_stochastic)

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    # (a) the main path: one 131,072-sample chunk of the 16-level 2^19
    # grid, 8 corners → 16,777,216 updates into 16·2^19 rows; (a') the same
    # at uniform positions, which spread the updates over the rows; (e) each
    # of them one level at a time
    cfg = HashGridConfig()
    T = cfg.table_size
    M = x_main.shape[0]
    gout = torch.randn((M, cfg.n_levels, 1, 2), generator=g, device=dev)
    breakdowns = {}
    for name, x in (("a_main_path", x_main),
                    ("a_uniform_positions", torch.rand((M, 3), generator=g, device=dev))):
        rows, cw = _indices_weights_exact(x, cfg, 0, cfg.n_levels)
        idx, upd = rows.to(torch.int32), (cw[..., None] * gout).contiguous()
        del rows, cw
        cases.append(scatter_case(name, idx, upd, cfg.n_levels, T, False, reps=20))
        breakdowns[name] = per_level_breakdown(idx, upd, cfg, reps=20)
        del idx, upd

    # (b) a K2-shaped table: L'·T = 3·1024 (a multiple of 1024, not 4096)
    L, Tb, Mb = 3, 1024, 100_000
    idx = (torch.randint(0, Tb, (Mb, L, 8), generator=g, device=dev)
           + torch.arange(L, device=dev)[None, :, None] * Tb).to(torch.int32)
    upd_b = torch.randn((Mb, L, 8, 2), generator=g, device=dev)
    cases.append(scatter_case("b_k2_table", idx.contiguous(), upd_b, L, Tb, False,
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
                              cfg.n_levels, T, True, reps=10))

    # (f) a stochastic section of the main-path chunk: the hybrid encode's
    # levels 8-15, one corner a level, rows local to the section
    lv0 = 8
    rows, cw = _indices_weights_stochastic(x_main, cfg, lv0, cfg.n_levels)
    upd = (cw[..., None] * gout[:, lv0:]).contiguous()
    cases.append(scatter_case("f_stochastic_section", (rows - lv0 * T).to(torch.int32),
                              upd, cfg.n_levels - lv0, T, False, reps=20))
    del rows, cw, upd

    # (g) rows outside their level's slab (added, past the level's sum in
    # shared memory), negative and padding rows (dropped)
    L, Tg, Mg = 4, 4096, 60_000
    idx = (torch.randint(0, Tg, (Mg, L, 8), generator=g, device=dev)
           + torch.arange(L, device=dev)[None, :, None] * Tg).to(torch.int32)
    idx[::7, 1, 0] = idx[::7, 3, 0]          # level 1's entry in level 3's slab
    idx[::11, 2, 5] = -3
    idx[::13, 0, 1] = L * Tg
    cases.append(scatter_case("g_foreign_rows", idx,
                              torch.randn((Mg, L, 8, 2), generator=g, device=dev),
                              L, Tg, False, reps=10))

    # (h) an odd M and T: ragged tiles, levels that each fit shared memory
    # in a table that does not
    L, Th, Mh = 16, 3 * 1024, 100_003
    idx = (torch.randint(0, Th, (Mh, L, 8), generator=g, device=dev)
           + torch.arange(L, device=dev)[None, :, None] * Th).to(torch.int32)
    cases.append(scatter_case("h_odd_m_and_t", idx,
                              torch.randn((Mh, L, 8, 2), generator=g, device=dev),
                              L, Th, False, reps=10))
    return cases, breakdowns


def same_values(a, b) -> bool:
    """Bit-for-bit equality of two float tensors, NaN equal to NaN."""
    import torch

    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(torch.int32).masked_fill(nan, 0),
                                b.view(torch.int32).masked_fill(nan, 0)))


def gather_case(name, table, sidx, reps):
    """The gather kernel against its plain version (bit for bit) and, where
    every index is in range, one ``index_select`` on a table rounded
    beforehand (a yardstick: the port never calls it)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.gather import (sorted_window_gather,
                                                         sorted_window_gather_plain)

    T, F = table.shape
    M = sidx.shape[0]
    out = sorted_window_gather(table, sidx)
    plain = sorted_window_gather_plain(table, sidx)
    torch.cuda.synchronize()
    finite = out.isfinite() & plain.isfinite()
    max_abs = float(torch.where(finite, (out - plain).abs(), 0.0).max())
    clamped = sidx.clamp(0, T - 1)
    distinct = int(torch.unique(clamped).numel())
    bytes_moved = M * 4 + M * F * 4 + distinct * F * table.element_size()
    row = {
        "case": name, "items": M, "table_rows": T, "features": F,
        "table_dtype": str(table.dtype).replace("torch.", ""),
        "distinct_rows": distinct, "equal": same_values(out, plain),
        "max_abs_err": max_abs,
        "ms": cuda_ms(lambda: sorted_window_gather(table, sidx), reps),
        "plain_ms": cuda_ms(lambda: sorted_window_gather_plain(table, sidx), reps),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, M * F / F32_FLOPS) * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    if bool((clamped == sidx).all()):
        rounded = table.to(torch.bfloat16).float()
        row["library_ms"] = cuda_ms(lambda: rounded.index_select(0, sidx), reps)
        row["library"] = "index_select on a table rounded to bf16 beforehand"
    row["ok"] = row["equal"]
    return row


def gather_cases(dev, floor):
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    cases = []

    # (a) the floor path's shape: 2^18 samples x 16 levels x 8 corners,
    # each level's rows sorted, concatenated (globally sorted)
    table, _, _, idx_lm = floor.make_inputs(2 ** 18, dev, SEED)
    sidx = floor.sort_levels(idx_lm)[0].reshape(-1)
    del idx_lm
    cases.append(gather_case("a_floor_path", table, sidx, reps=10))

    # (e) the same table, unsorted indices
    Me = 2 ** 22
    unsorted = torch.randint(0, table.shape[0], (Me,), generator=g, device=dev,
                             dtype=torch.int32)
    case_e = gather_case("e_unsorted", table, unsorted, reps=10)
    del table, sidx, unsorted

    # (b) the three shapes of the reference kernel's tests
    t8k = torch.randn((8192, 2), generator=g, device=dev)
    t32k = torch.randn((32768, 2), generator=g, device=dev)
    rand_sorted = torch.sort(torch.randint(0, 8192, (3000,), generator=g, device=dev,
                                           dtype=torch.int32))[0]
    wide = torch.sort((torch.arange(1024, device=dev, dtype=torch.int32) * 31) % 32768)[0]
    edges = torch.tensor([0, 0, 0, 1, 4095, 4096, 8191, 8191], dtype=torch.int32,
                         device=dev)
    cases.append(gather_case("b_rows_8192x3000", t8k, rand_sorted, reps=20))
    cases.append(gather_case("b_wide_span_32768x1024", t32k, wide, reps=20))
    cases.append(gather_case("b_duplicates_edges", t8k, edges, reps=20))

    # (c) negative indices and padding >= T, a length that is no multiple
    # of 1024
    padded = torch.cat([torch.tensor([-7, -1, -1], dtype=torch.int32, device=dev),
                        rand_sorted[:2990],
                        torch.arange(8192, 8200, dtype=torch.int32, device=dev)])
    cases.append(gather_case("c_negative_and_padding_3001", t8k, padded, reps=20))

    # (d) a bf16 table
    tb = torch.randn((16 * 4096, 2), generator=g, device=dev).to(torch.bfloat16)
    sb = torch.sort(torch.randint(0, tb.shape[0], (2 ** 20,), generator=g, device=dev,
                                  dtype=torch.int32))[0]
    cases.append(gather_case("d_bf16_table", tb, sb, reps=20))
    cases.append(case_e)

    # (f) a width other than the hash grid's 2 (the generic kernel)
    t4 = torch.randn((5000, 4), generator=g, device=dev)
    s4 = torch.sort(torch.randint(-5, 5010, (100_003,), generator=g, device=dev,
                                  dtype=torch.int32))[0]
    cases.append(gather_case("f_width_4", t4, s4, reps=20))

    # (g) NaN, infinities, denormals, ties of the bf16 rounding
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                            1e-40, -1e-40, 1.17549435e-38, 3.4028235e38,
                            1.00390625, 1.01171875, 65504.0], device=dev)
    ts = torch.stack([special, special.flip(0)], dim=1).contiguous()
    sg = torch.arange(ts.shape[0], dtype=torch.int32, device=dev)
    cases.append(gather_case("g_special_values", ts, sg, reps=5))
    return cases


def load_floor_script():
    """scripts/bench_torch_fused_render_floor.py as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "bench_torch_fused_render_floor.py")
    spec = importlib.util.spec_from_file_location("bench_torch_fused_render_floor",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encode_floor(dev, floor):
    """The sorted-encode floor path, with the launch counts set to 0 just
    before it and read just after."""
    from stable_nerf_tpu_torch.ops.hopper.gather import sorted_window_gather
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level

    sorted_window_gather.launches = 0
    hash_scatter_add_per_level.launches = 0
    row = floor.measure(2 ** 18, dev, SEED)
    launches = sorted_window_gather.launches
    row = {"phase": "encode_floor", **row, "gather_launches": launches}
    row["ok"] = bool(row["realigned_equal"] and launches > 0)
    return row


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


def make_batch(cfg, dev, g, n_scenes):
    """Random images in [-1, 1] and the rays of random poses, ``n_scenes``
    target/reference pairs."""
    import torch

    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses

    enc, img = cfg.latent_hw, cfg.sd.sd.image_size
    intr = (float(enc), float(enc), enc / 2, enc / 2)
    rt = get_rays(rand_poses(g, n_scenes, radius=2.0), intr, enc, enc)
    rr = get_rays(rand_poses(g, n_scenes, radius=2.0), intr, enc, enc)
    shape = (n_scenes, 3, img, img)
    return {
        "target_image": torch.rand(shape, generator=g, device=dev) * 2 - 1,
        "reference_image": torch.rand(shape, generator=g, device=dev) * 2 - 1,
        "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
        "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"],
    }


def make_setup(cfg, dev, seed):
    """Params, grid (all occupied), scheduler and a batch of one scene."""
    import torch

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
    return params, mask, grid, scheduler, make_batch(cfg, dev, g, 1)


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


def serve_parity(dev):
    """The tiny inference step (5 DDIM steps, float32, a sparse occupancy
    grid so compaction sees a real mask) on ``dev`` against the CPU, same
    params and draws.  Tolerance: every result key within 1e-3 of its
    largest reference entry (SSIM, a mean over [-1, 1] that is near 0
    here, within 1e-3 absolutely); float32 sums in other orders, through
    five U-Net passes and the VAE decode."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.utils.tree import tree_map

    cfg = tiny_joint_config()
    cpu = torch.device("cpu")
    params, _, grid, _, _ = make_setup(cfg, cpu, SEED)
    g = torch.Generator().manual_seed(SEED + 7)
    batch = make_batch(cfg, cpu, g, SERVE_BATCH)
    # a table wide enough for the render to differ from the background
    params["nerf"]["hash"]["table"].mul_(1e4)
    grid = grid._replace(occ=torch.rand(grid.occ.shape, generator=g) < 0.4)
    enc = cfg.latent_hw
    draws = {"vae_eps": torch.randn((SERVE_BATCH, 4, enc, enc), generator=g),
             "init_latents": torch.randn((SERVE_BATCH, 4, enc, enc), generator=g)}
    results = {}
    for d in (cpu, dev):
        step = make_inference_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device=d),
                                   5, compute_dtype=torch.float32, guidance_scale=3.0,
                                   capture_attn_maps=True, device=d)
        out = step(tree_map(lambda x: x.to(d), params),
                   OccupancyGridState(*(t.to(d) for t in grid)),
                   {k: v.to(d) for k, v in batch.items()},
                   draws={k: v.to(d) for k, v in draws.items()})
        out["ip_attn_maps"] = torch.cat([m.reshape(-1) for m in out["ip_attn_maps"]])
        results[d.type] = {k: v.float().cpu() for k, v in out.items()}
    errs = {k: float((results[dev.type][k] - ref).abs().max()
                     / (1.0 if k == "ssim" else ref.abs().max().clamp_min(1e-30)))
            for k, ref in results["cpu"].items()}
    row = {"phase": "serve_parity", "ddim_steps": 5, "guidance_scale": 3.0,
           "rel_err_by_key": errs, "tolerance": 1e-3}
    row["ok"] = bool(all(e <= 1e-3 for e in errs.values()))
    return row


def joint_full(dev, cfg, setup, steps):
    """Full-width train steps; returns the phase row and the step (launch
    count read right after the steps)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.gather import sorted_window_gather
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
    sorted_window_gather.launches = 0
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
    return row, (step, params, grid, batch, g), opt


def joint_budget(dev, cfg, setup, opt, steps):
    """Train steps with a binding sample budget: the compaction branch
    under gradient, the scatter kernel on compacted positions."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.training.joint import make_train_step
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    params, _, grid, sched, batch = setup
    step = make_train_step(cfg, sched, opt, sample_budget=TRAIN_BUDGET, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = hash_scatter_add_per_level.launches
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    launches = hash_scatter_add_per_level.launches - before
    chunks = TRAIN_BUDGET // 2 ** 17
    # what stays on the card between steps: params, optimizer moments,
    # grid and batch
    held = (tree_leaves(params) + list(grid) + list(batch.values())
            + [v for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)])
    state_bytes = sum(x.numel() * x.element_size() for x in held)
    row = {"phase": "joint_train_budget", "steps": steps,
           "sample_budget": TRAIN_BUDGET, "scatter_launches": launches,
           "expected_launches": chunks * steps, "step_ms": times, "losses": losses,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "state_bytes": state_bytes}
    row["ok"] = bool(all(math.isfinite(v) for l in losses for v in l.values())
                     and launches == chunks * steps)
    return row


def serve(dev, cfg, setup):
    """Full-width inference requests, batches of SERVE_BATCH scenes: the
    eval render at 512 march steps and 64 samples a ray, 50 DDIM steps,
    f32 VAE decode, metrics.  Each stage's ms is the host clock between
    synchronizes at the stage's end."""
    import torch

    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.training.joint import eval_sample_budget

    params, _, grid, sched, _ = setup
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    marks = []

    def hook(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    def request(step, batch):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        stages, prev = {}, t0
        for name, t in marks:
            stages[name] = (t - prev) * 1e3
            prev = t
        return out, total, stages

    n_steps = cfg.train.num_inference_steps
    step = make_inference_step(cfg, sched, n_steps, device=dev, stage_hook=hook)
    torch.cuda.reset_peak_memory_stats()
    requests, ok = [], True
    img = cfg.sd.sd.image_size
    for _ in range(SERVE_REQUESTS):
        out, total, stages = request(step, make_batch(cfg, dev, g, SERVE_BATCH))
        d = out["denoised_image"]
        metrics = {k: out[k].float().reshape(-1).tolist()
                   for k in ("psnr", "ssim", "l2_loss", "latent_psnr")}
        ok = ok and (tuple(d.shape) == (SERVE_BATCH, 3, img, img)
                     and bool(d.isfinite().all()) and float(d.min()) >= 0.0
                     and float(d.max()) <= 1.0
                     and all(math.isfinite(v) for m in metrics.values() for v in m))
        requests.append({"ms": total, "stages_ms": stages, "metrics": metrics})
    peak = torch.cuda.max_memory_allocated(dev)
    guided = make_inference_step(cfg, sched, n_steps, device=dev, guidance_scale=3.0,
                                 stage_hook=hook)
    _, g_total, g_stages = request(guided, make_batch(cfg, dev, g, SERVE_BATCH))
    n_rays = SERVE_BATCH * cfg.latent_hw ** 2
    timed = requests[1:]
    row = {"phase": "serve", "scenes_per_request": SERVE_BATCH, "ddim_steps": n_steps,
           "eval_march_steps": cfg.train.max_steps_eval,
           "lattice": n_rays * cfg.train.max_steps_eval,
           "sample_budget": eval_sample_budget(n_rays, cfg.train),
           "requests": requests,
           "steady_request_ms": statistics.mean(r["ms"] for r in timed),
           "steady_ms_per_view": statistics.mean(r["ms"] for r in timed) / SERVE_BATCH,
           "steady_stages_ms": {k: statistics.mean(r["stages_ms"][k] for r in timed)
                                for k in timed[0]["stages_ms"]},
           "guidance_3_request_ms": g_total, "guidance_3_stages_ms": g_stages,
           "max_memory_allocated": peak, "ok": bool(ok)}
    return row, (step, params, grid, make_batch(cfg, dev, g, SERVE_BATCH), g)


class SceneSubset:
    """The first ``n`` scenes of a dataset, with what the training loop
    reads of one: ``__len__``, ``__getitem__``, ``intrinsic``, ``all_poses()``."""

    def __init__(self, ds, n):
        self.ds, self.n, self.intrinsic = ds, n, ds.intrinsic

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.ds[i]

    def all_poses(self):
        import numpy as np

        return np.concatenate([self.ds.reference_poses[:self.n],
                               self.ds.target_poses[:self.n]])


class LoopLog:
    """The training loop's log lines, with the scatter launches counted
    from one epoch's grid refresh to the end of its train steps and
    validation (neither the refresh, nor validation, nor inference has a
    backward)."""

    PATTERNS = {
        "trainable": r"grid: ([\d.]+) of the cells seen by a camera",
        "refresh": r"epoch (\d+): grid refresh ([\d.]+) ms, occupied ([\d.]+)",
        "epoch": r"epoch (\d+): train \S+ val \S+ \(\d+ rays/s, (\d+) steps in ([\d.]+) s\)",
        "saved": r"checkpoint step (\d+) saved: (\d+) bytes in ([\d.]+) s",
        "resumed": r"resumed from checkpoint step (\d+) .* in ([\d.]+) s",
        "validation": r"epoch (\d+): validation (\d+) batches in ([\d.]+) s",
        "inference": r"epoch (\d+): inference (\d+) requests in ([\d.]+) s",
        "verified": r"checkpoints: frozen checksum verified",
    }

    def __init__(self, counter):
        self.counter, self.found = counter, []
        self._start = 0

    def __call__(self, line):
        import re

        line = str(line)
        for kind, pat in self.PATTERNS.items():
            m = re.search(pat, line)
            if m:
                found = (kind,) + m.groups()
                if kind == "refresh":
                    self._start = self.counter.launches
                elif kind == "epoch":
                    found += (self.counter.launches - self._start,)
                self.found.append(found)

    def of(self, kind):
        return [f[1:] for f in self.found if f[0] == kind]


def train_loop(dev, cfg, here):
    """The port's training loop at full width: random weights (seed 0), 10
    scenes of the committed synthetic scene at 512² / 64² (an 8 / 1 / 1
    split), two epochs (epoch 0 on the stochastic encode, epoch 1 exact,
    validation each, one inference request of 50 DDIM steps, a
    trainable-only checkpoint each), then a resume to a third epoch.  A
    restore through CheckpointManager must equal the params, AdamW state
    and grid the first run ended with, bit for bit."""
    import dataclasses
    import shutil

    import torch

    from stable_nerf_tpu_torch.data.dataset import StableNeRFDataset, iterate, split_dataset
    from stable_nerf_tpu_torch.data.prefetch import device_prefetch
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.training import loop
    from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
    from stable_nerf_tpu_torch.training.joint import joint_trainable_mask, make_train_step
    from stable_nerf_tpu_torch.utils.tree import partition, tree_leaves

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2, stochastic_until_epoch=1, val_every=1, inference_every=2,
        checkpoint_every=1, checkpoint_trainable_only=True, seed=SEED))
    workdir = os.path.join(here, ".cache", "chip_smoke_train_loop")
    shutil.rmtree(workdir, ignore_errors=True)
    t = time.perf_counter()
    ds = SceneSubset(StableNeRFDataset("synthetic", shape=cfg.sd.sd.image_size,
                                       encoded_shape=cfg.latent_hw, seed=SEED,
                                       root=os.path.join(here, "datasets")), LOOP_SCENES)
    data_s = time.perf_counter() - t
    optimizers = []
    make_optimizer = loop.make_optimizer

    def keep_optimizer(*a, **kw):          # the optimizer the first run ends with
        optimizers.append(make_optimizer(*a, **kw))
        return optimizers[-1]

    log = LoopLog(hash_scatter_add_per_level)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hash_scatter_add_per_level.launches = 0
    loop.make_optimizer = keep_optimizer
    try:
        t = time.perf_counter()
        params, grid, history = loop.train(cfg, ds, workdir=workdir, seed=SEED,
                                           log_fn=log, device=dev)
        first_s = time.perf_counter() - t
    finally:
        loop.make_optimizer = make_optimizer
    launches_first = hash_scatter_add_per_level.launches
    peak_first = torch.cuda.max_memory_allocated(dev)
    opt = optimizers[0]

    # restore into a fresh run's live tensors, as a resume does
    t = time.perf_counter()
    fresh = loop.build_initial_params(cfg, SEED, SEED + 1, device=dev)
    mask = joint_trainable_mask(fresh, cfg.train.trainable_scope)
    fresh_opt = make_optimizer(cfg.train, fresh, mask)
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))
    state = ckpt.restore(template={"trainable": partition(fresh, mask)[0],
                                   "opt_state": None, "extra": None,
                                   "grid_state": grid_init(cfg.nerf, device=dev)})
    fresh_opt.load_state_dict(state["opt_state"]["optimizer"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    params_equal = all(torch.equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(tree_leaves(params), tree_leaves(fresh)))
    grid_equal = all(torch.equal(a, b) for a, b in zip(grid, state["grid_state"]))
    opt_equal = all(
        set(opt.state[p]) == set(fresh_opt.state[q])
        and all(torch.equal(v.cpu(), fresh_opt.state[q][k].cpu())
                for k, v in opt.state[p].items())
        for p, q in zip([p for g in opt.param_groups for p in g["params"]],
                        [q for g in fresh_opt.param_groups for q in g["params"]]))
    opt_steps = sorted({int(st["step"]) for st in fresh_opt.state.values()})
    del fresh, fresh_opt, state

    # the loop's own step on the same train batches outside the loop, each
    # timed over a synchronize as joint_train times its steps: what the
    # loop adds around a step is its epoch time less these
    step = make_train_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device=dev), opt,
                           device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    tr_idx = split_dataset(len(ds), seed=SEED)[0]
    step_ms = []
    for batch in device_prefetch(iterate(ds, tr_idx, cfg.train.batch_size), device=dev):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    del params, grid, opt, optimizers, step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    hash_scatter_add_per_level.launches = 0
    t = time.perf_counter()
    _, grid, history2 = loop.train(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, epochs=3)), ds, workdir=workdir,
        seed=SEED, resume=True, log_fn=log, device=dev)
    resume_s = time.perf_counter() - t
    launches_resume = hash_scatter_add_per_level.launches
    peak_resume = torch.cuda.max_memory_allocated(dev)

    # the host side of the data path alone: collate, pin, copy to the card
    torch.cuda.synchronize()
    t = time.perf_counter()
    n_batches = sum(1 for _ in device_prefetch(iterate(ds, tr_idx, cfg.train.batch_size),
                                               device=dev))
    torch.cuda.synchronize()
    prefetch_ms = (time.perf_counter() - t) * 1e3 / n_batches

    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs_rec = [r for r in records if r.get("kind") != "inference"]
    inference_rec = [r for r in records if r.get("kind") == "inference"]
    finite = all(math.isfinite(v) for r in records for k, v in r.items() if k != "kind")
    steps = len(split_dataset(len(ds), seed=SEED)[0]) // cfg.train.batch_size
    samples = 2 * cfg.train.batch_size * cfg.latent_hw ** 2 * cfg.train.max_steps_train
    chunks = samples // 2 ** 17 if samples > 2 ** 17 and samples % 2 ** 17 == 0 else 1
    refresh = log.of("refresh")
    per_epoch = []
    for (e, n, wall, launches), (_, ms, occ) in zip(log.of("epoch"), refresh):
        e = int(e)
        per_epoch.append({
            "epoch": e, "encode": "stochastic" if e < cfg.train.stochastic_until_epoch
            else "exact", "steps": int(n), "train_wall_s": float(wall),
            "steps_per_s": int(n) / float(wall), "grid_refresh_ms": float(ms),
            "occupied_fraction": float(occ), "scatter_launches": launches,
            "expected_launches": None if e < cfg.train.stochastic_until_epoch
            else chunks * int(n)})
    exact_ok = all(r["scatter_launches"] == r["expected_launches"] for r in per_epoch
                   if r["expected_launches"] is not None)
    trainable = float(log.of("trainable")[0][0])
    row = {
        "phase": "train_loop", "scenes": LOOP_SCENES, "image": cfg.sd.sd.image_size,
        "latent": cfg.latent_hw, "dataset_load_s": data_s, "first_call_s": first_s,
        "resume_call_s": resume_s, "epochs": per_epoch,
        "grid_trainable_share": trainable,
        "checkpoints": [{"step": int(s), "bytes": int(b), "save_s": float(sec)}
                        for s, b, sec in log.of("saved")],
        "resume_restore_s": [float(sec) for _, sec in log.of("resumed")],
        "check_restore_s": restore_s, "frozen_checksum_verified": bool(log.of("verified")),
        "validation_s": [float(sec) for _, _, sec in log.of("validation")],
        "inference_s": [float(sec) for _, _, sec in log.of("inference")],
        "prefetch_ms_per_batch": prefetch_ms,
        "step_ms_outside_loop": step_ms,
        "restore_equal": {"params": params_equal, "adamw_state": opt_equal,
                          "grid": grid_equal},
        "adamw_steps_restored": opt_steps,
        "metrics_records": {"epoch": len(epochs_rec), "inference": len(inference_rec)},
        "losses": [[r["train_loss"], r["val_loss"]] for r in epochs_rec],
        "inference": inference_rec, "scatter_launches": launches_first + launches_resume,
        "steps_per_epoch": steps, "max_memory_allocated": {"first_call": peak_first,
                                                          "resume_call": peak_resume},
    }
    row["ok"] = bool(
        [r["epoch"] for r in per_epoch] == [0, 1, 2] and exact_ok and trainable > 0
        and params_equal and opt_equal and grid_equal and opt_steps == [2 * steps]
        and row["frozen_checksum_verified"] and len(epochs_rec) == 3
        and len(inference_rec) == 1 and finite and [r["epoch"] for r in history2] == [2]
        and int(grid.iter_density) == 3 and launches_first + launches_resume > 0)
    shutil.rmtree(workdir, ignore_errors=True)
    return row


def cli(here):
    """``python -m stable_nerf_tpu_torch.train`` on the card: a tiny one-epoch
    run over the synthetic scene, then ``--inference`` on its workdir."""
    import glob
    import shutil

    workdir = os.path.join(here, "chiprun_out", "cli")
    shutil.rmtree(workdir, ignore_errors=True)
    common = [sys.executable, "-m", "stable_nerf_tpu_torch.train", "--tiny", "--dataset",
              "synthetic", "--image-size", "32", "--latent-size", "16", "--workdir", workdir]
    runs = {}
    for name, extra in (("train", ["--epochs", "1"]), ("inference", ["--inference"])):
        t = time.perf_counter()
        out = subprocess.run(common + extra, cwd=here, capture_output=True, text=True,
                             timeout=600)
        runs[name] = {"rc": out.returncode, "s": time.perf_counter() - t,
                      "tail": out.stdout.strip().splitlines()[-3:]}
        if out.returncode:
            print(out.stdout[-4000:] + out.stderr[-4000:], file=sys.stderr)
    renders = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(workdir, "renders", "denoised_*")))
    row = {"phase": "cli", "runs": runs, "metrics_jsonl": os.path.exists(
               os.path.join(workdir, "metrics.jsonl")),
           "checkpoints": sorted(os.listdir(os.path.join(workdir, "checkpoints")))
           if os.path.isdir(os.path.join(workdir, "checkpoints")) else [],
           "renders": renders}
    row["ok"] = bool(all(r["rc"] == 0 for r in runs.values()) and row["metrics_jsonl"]
                     and row["checkpoints"] and renders)
    return row


def profile_step(state, out_dir, what):
    """One more call of a step (``what``: "joint_step" or "serve_request")
    under torch.profiler: device time by kernel name, the busy share of the
    call's wall time, and the full table in out_dir."""
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
    path = os.path.join(out_dir, what + "_kernels.json")
    with open(path, "w") as f:
        json.dump({"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
                   "launches": len(spans), "kernels_ms_count": table}, f, indent=1)
    return {"phase": "profile", "of": what, "wall_ms": wall_ms,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            "kernel_ms_sum": sum(r[1] for r in table), "launches": len(spans),
            "top": [[n[:90], ms, c] for n, ms, c in table[:12]],
            "table": path}


def scatter_bench(dev, cfg, smi) -> int:
    """The scatter kernel's cases alone, on the batch a full run makes
    (same seeds, no weights)."""
    import torch

    import stable_nerf_tpu_torch

    batch = make_batch(cfg, dev, torch.Generator(device=dev).manual_seed(SEED + 2), 1)
    x_main = main_path_positions(cfg, batch, dev,
                                 torch.Generator(device=dev).manual_seed(SEED + 5))
    cases, breakdowns = kernel_cases(dev, x_main)
    emit({"phase": "scatter_bench",
          "package": os.path.relpath(os.path.dirname(stable_nerf_tpu_torch.__file__),
                                     os.path.dirname(os.path.abspath(__file__))),
          "nvidia_smi": smi, "cases": cases, "e_per_level": breakdowns})
    print(smi, flush=True)
    failed = [c["case"] for c in cases if not c["ok"]]
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one more train step and one more serving request and "
                         "write the tables to DIR")
    ap.add_argument("--scatter-bench", action="store_true",
                    help="run only the card phase and the scatter kernel's cases, with "
                         "the main-path chunk one level at a time, and stop")
    ap.add_argument("--root", metavar="DIR",
                    help="with --scatter-bench: measure the stable_nerf_tpu_torch "
                         "package under DIR, another checkout unpacked below this "
                         "script's directory (e.g. the parent commit's), with this "
                         "script's cases")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        if not args.scatter_bench:
            ap.error("--root goes with --scatter-bench")
        here = os.path.dirname(os.path.abspath(__file__))
        root = os.path.realpath(args.root)
        if os.path.commonpath([root, os.path.realpath(here)]) != os.path.realpath(here):
            ap.error(f"--root must lie below {here}")
        sys.path.insert(0, root)
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
    if args.scatter_bench:
        return scatter_bench(dev, cfg, smi)
    t = time.perf_counter()
    setup = make_setup(cfg, dev, SEED)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(setup[0]))})

    x_main = main_path_positions(cfg, setup[4], dev,
                                 torch.Generator(device=dev).manual_seed(SEED + 5))
    cases, breakdowns = kernel_cases(dev, x_main)
    emit({"phase": "kernel_cases", "cases": cases, "e_per_level": breakdowns})
    del x_main
    floor = load_floor_script()
    gathers = gather_cases(dev, floor)
    emit({"phase": "gather_cases", "cases": gathers})
    phases = [encode_floor(dev, floor), parity_small(dev), serve_parity(dev)]
    for row in phases:
        emit(row)
    floor_row = phases[0]
    joint, state, opt = joint_full(dev, cfg, setup, JOINT_STEPS)
    emit(joint)
    phases += [joint, joint_budget(dev, cfg, setup, opt, BUDGET_STEPS)]
    emit(phases[-1])
    served, serve_state = serve(dev, cfg, setup)
    emit(served)
    phases.append(served)
    if args.profile:
        emit(profile_step(state, args.profile, "joint_step"))
        emit(profile_step(serve_state, args.profile, "serve_request"))
    del setup, state, serve_state, opt
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    looped = train_loop(dev, cfg, here)
    emit(looped)
    phases.append(looped)
    phases.append(cli(here))
    emit(phases[-1])

    a, ga = cases[0], gathers[0]
    emit({"kernels": [{
        "name": "hash_scatter_add", "route": "cuda",
        "source": "stable_nerf_tpu_torch/csrc/hash_scatter.cu",
        "replaces": "stable_nerf_tpu/ops/pallas/scatter_v2.py:125",
        "also_replaces": "stable_nerf_tpu/ops/pallas/scatter.py:113",
        "launches": joint["scatter_launches"],
        "launches_by_path": {"joint_train": joint["scatter_launches"],
                             "train_loop": looped["scatter_launches"]},
        "max_abs_err": a["kernel_vs_plain_max_abs"],
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
    }, {
        "name": "sorted_window_gather", "route": "cuda",
        "source": "stable_nerf_tpu_torch/csrc/sorted_gather.cu",
        "replaces": "stable_nerf_tpu/ops/pallas/gather.py:114",
        "launches": floor_row["gather_launches"],
        "max_abs_err": ga["max_abs_err"],
        "ms": ga["ms"], "plain_ms": ga["plain_ms"], "bound_ms": ga["bound_ms"],
        "bound_by": ga["bound_by"], "library_ms": ga["library_ms"],
    }]})
    print(smi, flush=True)
    failed = ([c["case"] for c in cases + gathers if not c["ok"]]
              + [row["phase"] for row in phases if not row["ok"]])
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
