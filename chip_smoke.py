#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stable_nerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each printed as one JSON line; any failure exits non-zero:
  card         the card's name and power limit; the CUDA kernels built from
               stable_nerf_tpu_torch/csrc/ (every source compiled at once;
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
               each with the zero fill's time apart; (i) comes with fit_nerf;
               then the hash-encode kernel, forward and backward, on chunk
               a, exact and one corner a level (kernel, bound and plain ms);
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
  pretrained   a full-width SDXL directory (U-Net, VAE, CLIP-L and bigG
               text towers, float16, seed 7) written through the port's
               safetensors writer; precheck, fingerprint and load_sdxl
               timed (GB/s, peak host RSS); the empty-prompt conditioning
               on the card against the CPU; build_initial_params with the
               weights, every frozen leaf checked bit for bit against the
               exported values; device peaks with and without the weights;
  cli          python -m stable_nerf_tpu_torch.train --tiny on the synthetic
               scene for one epoch, then --inference on its workdir; then
               at full width, --dataset objaverse (10 objects of RGBA 512²
               PNGs written by this script) with --sdxl-checkpoint (the
               pretrained phase's directory) for one epoch, then
               --inference: load seconds an object, steps, scatter
               launches (16 a dense step), PSNR.  The SDXL directory and
               the data are removed at the end.
  fit_nerf     scripts/fit_torch_nerf.py's fit at its defaults (128², 4,096
               rays a step, 256 march steps, exact encode) for 200 steps: s
               a step, scatter launches (8 a step run in Python; the
               steps replayed from the fit step's CUDA graph launch theirs
               inside it), loss at the start and
               the end, the 8-view mean PSNR before and after (it must
               rise), peak memory; then (i) the scatter kernel on one chunk
               of the trained fit's backward against its plain version,
               with each level's distinct rows, the atomics left after
               merging and the share of zero updates;
  demo         the committed tiny VAE (runs/demo_vae/vae.npz) on the card,
               its VAE(white) latent background against the JAX package's
               within 1e-3; python -m stable_nerf_tpu_torch.train --dataset
               synthetic --demo --vae-checkpoint runs/demo_vae/vae.npz for 2
               epochs at batch 8, then --inference: per-epoch losses, s an
               epoch, scatter launches (8 a step), PSNR, peak memory;
  sd_scripts   (inside the pretrained phase's span, on its SDXL directory)
               scripts/validate_torch_sdxl_checkpoint.py (checksums; every
               check passes but the VAE reconstruction's 20 dB, which seeded
               weights fail by design) and scripts/run_torch_sd.py
               --sdxl-checkpoint --steps 50 (reconstruction MSE, cold and
               steady steps/s, denoised image under chiprun_out/sd_scripts);
  profile_sd   scripts/profile_torch_sd_denoise.py --steps 3: device time
               of a denoise step by bucket, idle share, analytic MFU;
  remat        the full-width step with ``UNetConfig.remat``: its losses
               against the plain step's on the same params and draws (equal
               within 1e-6), the forward-and-backward peaks of both, then 3
               train steps: ms, peak, scatter launches;
  dp_train_world1  the full-width step through the data-parallel step at
               world 1 on NCCL, 3 steps: ms against joint_train's, bytes
               and calls all-reduced a step, the all-reduce's ms on those
               gradients alone, scatter launches, peak;
  dp_train, fsdp_train  two ranks on the one card (two processes of this
               script, ``--rank-worker``, over gloo, named: NCCL refuses two
               ranks on one device).  A probe of gloo's
               all_gather_into_tensor and reduce_scatter_tensor on CUDA
               tensors; each mode's tiny float32 update against one
               process's on the global batch of 2 (dp: two accumulated rows,
               fsdp: the batch of 2; losses within 1e-5, each leaf's update
               within 1e-3 in L2), then 2 full-width steps a rank: ms,
               scatter launches, peak, resting bytes.  fsdp_train fails
               where the probe does;
  cli_dp       python -m stable_nerf_tpu_torch.train --tiny --data-parallel
               --fsdp --remat for one epoch (a world of one on NCCL), then
               --inference;
  tp_serve, sp_serve  two ranks on the card over gloo (``--rank-worker DIR
               --rank-job serve``) serve the full-width request (2 scenes,
               512 eval march steps, 64 samples a ray, 50 DDIM steps, f32
               decode) with the U-Net tensor-parallel (tp 2), then
               sequence-parallel (sp 2, ring attention): ms a request,
               all-reduces or ring hops and their bytes, each rank's peak;
               the ranks' images bit-equal, the same weights and draws as
               one process's 10-step request (on the seed's weights, the
               serve phase's kernels warm), held to it by PSNR; a tiny float32
               request (5 DDIM steps, guidance 3) held to one process's key
               by key.  sp_serve also records a probe of gloo's
               point-to-point path on CUDA tensors (the ring stages its
               blocks through the host on gloo);
  tp_train     two tensor-parallel ranks: the tiny float32 update against
               one process's on the global batch of 2, then 2 full-width
               steps a rank (ms, K1 launches, peak and resting bytes against
               a dp_train rank's);
  fsdp_tp_train  four ranks, data 2 x model 2, fully sharded over data: the
               tiny float32 update against one process's;
  run_sd_sharded  scripts/run_torch_sd.py's sharded denoise (``denoise(...,
               mesh=)``) at full width (512², bf16, 3 DDIM steps) on two
               ranks over gloo (``--rank-job run_sd``), tp 2 then sp 2:
               s a step, all-reduces or ring hops and their bytes, the
               ranks' latents bit-equal and held to the script's
               single-process denoise from the same start latents; then
               ``python scripts/run_torch_sd.py --tp 2`` on this one-card
               machine must refuse (exit non-zero);
  scripts      the eight study scripts (scripts/bench_torch_{scatter_variants,
               step_ablation,eval_ablation,encode_split,table_dtype,
               gather_by_table,unet_layout,grid_refresh}.py) in this
               process at their defaults: every row finite, the scatter
               kernel's rows within 1e-5 of ``index_add_`` (of the largest
               magnitude), the kernel's launches per script; and
               scripts/make_torch_sdxl_key_manifest.py, whose output must
               equal the committed tests/fixtures/ manifests byte for byte.
               Inside sd_scripts, the check half of
               scripts/weights_torch_drill_full_size.py (precheck,
               fingerprint, strict load on the host, export, float16 bit
               compare) runs on the pretrained phase's directory.
Every phase's row carries its seconds (``seconds``; rows of one launch
share it, ``seconds_of`` names them); a ``run_time`` line sums them.
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
import gc
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
PRETRAINED_SEED = 7      # the written SDXL weights: not the loop's seed
OBJAVERSE_OBJECTS = 10   # objects of the CLI's objaverse run: an 8 / 1 / 1 split
FIT_STEPS = 200          # steps of the NeRF fit harness's run
DEMO_VAE = "runs/demo_vae/vae.npz"       # the committed JAX-trained tiny VAE
# the JAX package's VAE(white) latent background of DEMO_VAE in float32 on
# the CPU (tests/test_torch_demo.py holds it); its TPU run printed
# [0.5, 0.721, 0.42, 0.564] (runs/demo_diffusion.log), rounded to three
# places from convolutions with bf16 passes
DEMO_BG_F32 = (0.4997452, 0.7217328, 0.42126554, 0.56418204)
DEMO_BG_TPU_LOG = (0.5, 0.721, 0.42, 0.564)
DEMO_EPOCHS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def with_seconds(fn, *args):
    """``fn(*args)``, with the seconds it took written into every phase row
    it returns (a row, or rows in a tuple or list beside other results;
    rows of one call share its seconds and ``seconds_of`` names them)."""
    t = time.perf_counter()
    out = fn(*args)
    seconds = time.perf_counter() - t
    rows = [x for x in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(x, dict) and "phase" in x]
    for row in rows:
        row["seconds"] = seconds
        if len(rows) > 1:
            row["seconds_of"] = [r["phase"] for r in rows]
    return out


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


def clip_text_state_dict(params):
    """A CLIP text tower's tree → its HF transformers state dict (the
    inverse of ``clip_text.params_from_hf_state_dict``; linears back to
    [out, in], as views)."""
    sd = {}
    p = "text_model."

    def lin(name, q):
        sd[name + ".weight"] = q["kernel"].T
        sd[name + ".bias"] = q["bias"]

    def ln(name, q):
        sd[name + ".weight"] = q["scale"]
        sd[name + ".bias"] = q["bias"]

    for i, layer in enumerate(params["layers"]):
        lp = f"{p}encoder.layers.{i}."
        ln(lp + "layer_norm1", layer["ln1"])
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("out", "out_proj")):
            lin(f"{lp}self_attn.{name}", layer[key])
        ln(lp + "layer_norm2", layer["ln2"])
        lin(lp + "mlp.fc1", layer["fc1"])
        lin(lp + "mlp.fc2", layer["fc2"])
    sd[p + "embeddings.token_embedding.weight"] = params["token_embedding"]
    sd[p + "embeddings.position_embedding.weight"] = params["position_embedding"]
    ln(p + "final_layer_norm", params["final_ln"])
    if "text_projection" in params:
        sd["text_projection.weight"] = params["text_projection"].T
    return sd


def write_sdxl_checkpoint(directory, state_dicts, dtype=None):
    """Write {"unet" | "vae" | "text_encoder" | "text_encoder_2": state
    dict} as an SDXL directory in the HF hub layout, through the port's
    safetensors writer, each tensor stored in ``dtype`` (None: its own)."""
    from stable_nerf_tpu_torch.utils.safetensors import save_file

    names = {"unet": "diffusion_pytorch_model.safetensors",
             "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors", "text_encoder_2": "model.safetensors"}
    for sub, sd in state_dicts.items():
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
        save_file(sd, os.path.join(directory, sub, names[sub]), dtype=dtype)


def png_bytes(pixels) -> bytes:
    """[H, W, 3 | 4] uint8 → an 8-bit RGB(A) PNG: one IDAT, filter 0 on
    every row (the card's machine has no PIL)."""
    import struct
    import zlib

    import numpy as np

    h, w, c = pixels.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_objaverse(root, n_objects, size, views=12):
    """``root/objaverse/views_release`` in Objaverse's layout: ``n_objects``
    directories of ``views`` RGBA PNGs (alpha 255) and blender poses
    (``NNN.png``, ``NNN.npy``), cut from the committed synthetic scene's
    views and poses in turn, resized to ``size``²."""
    import numpy as np

    from stable_nerf_tpu_torch.data.preprocess import resize_bilinear_uint8

    here = os.path.dirname(os.path.abspath(__file__))
    scene = np.load(os.path.join(here, "datasets", "nerf", "synthetic_spheres.npz"))
    rgb = resize_bilinear_uint8((np.clip(scene["images"], 0, 1) * 255).astype(np.uint8),
                                (size, size))
    rgba = np.concatenate([rgb, np.full(rgb.shape[:3] + (1,), 255, np.uint8)], axis=-1)
    for o in range(n_objects):
        d = os.path.join(root, "objaverse", "views_release", f"object_{o:03d}")
        os.makedirs(d, exist_ok=True)
        for v in range(views):
            i = (o * views + v) % len(rgba)
            with open(os.path.join(d, f"{v:03d}.png"), "wb") as f:
                f.write(png_bytes(rgba[i]))
            np.save(os.path.join(d, f"{v:03d}.npy"), scene["poses"][i])


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


def encode_case(name, x, cfg, stochastic, min_level, reps):
    """The encode kernel, forward and backward (rows and updates for the
    scatter kernel), against the plain functions on the same positions: the
    rows and updates bit for bit, the features within 1e-6 of the table's
    largest magnitude.  Bounds count the positions (and in the backward
    the features' gradient) read once, the output written once and, in
    the forward, every corner's row gathered with no reuse."""
    import torch

    from stable_nerf_tpu_torch.ops import encoding
    from stable_nerf_tpu_torch.ops.hopper.encode import (hash_encode_backward,
                                                         hash_encode_forward)

    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    M = x.shape[0]
    g = torch.Generator(device=x.device).manual_seed(SEED)
    table = torch.rand((L * T, F), generator=g, device=x.device) * 2 - 1
    gout = torch.randn((M, L * F), generator=g, device=x.device)
    levels = encoding.level_table(cfg, stochastic, min_level)
    sections = encoding._sections(L, stochastic, min_level)

    def fwd():
        return hash_encode_forward(x, table, levels, T)

    def bwd():
        return [hash_encode_backward(x, gout, levels, lv0, lv1, T)
                for lv0, lv1, _ in sections]

    def plain_fwd():
        return encoding._encode_sections(
            table, encoding._hash_sections(x, cfg, stochastic, min_level))

    def plain_bwd():
        g4 = gout.reshape(M, L, 1, F)
        return [((rows - lv0 * T).to(torch.int32),
                 (cw[..., None] * g4[:, lv0:lv0 + rows.shape[1]]).contiguous())
                for lv0, rows, cw in encoding._hash_sections(x, cfg, stochastic, min_level)]

    out, want = fwd(), plain_fwd()
    got_b, want_b = bwd(), plain_bwd()
    torch.cuda.synchronize()
    gap = float((out - want).abs().max())
    tol = 1e-6 * float(table.abs().max())
    rows_equal = all(torch.equal(a[0], b[0]) for a, b in zip(got_b, want_b))
    upd_equal = all(torch.equal(a[1], b[1]) for a, b in zip(got_b, want_b))
    del out, want, got_b, want_b
    corners = sum((lv1 - lv0) * (1 if one else 8) for lv0, lv1, one in sections)
    fwd_bytes = M * 12 + M * L * F * 4 + M * corners * F * 4
    bwd_bytes = M * 12 + M * L * F * 4 + M * corners * (4 + F * 4)
    row = {
        "case": name, "samples": M, "levels": L, "corners_a_sample": corners, "features": F,
        "rows_equal": rows_equal, "updates_equal": upd_equal,
        "features_max_abs_gap": gap, "features_tolerance": tol,
        "forward_ms": cuda_ms(fwd, reps, queued=True),
        "forward_bound_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
        "forward_plain_ms": cuda_ms(plain_fwd, 3, queued=True),
        "backward_ms": cuda_ms(bwd, reps, queued=True),
        "backward_bound_ms": bwd_bytes / HBM_BYTES_PER_S * 1e3,
        "backward_plain_ms": cuda_ms(plain_bwd, 3, queued=True),
        "bound_by": "bytes",
    }
    row["ok"] = bool(rows_equal and upd_equal and gap <= tol)
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

    # the encode kernel on the same chunk: exact (the train and fit
    # cells) and one corner a level (the stochastic fit)
    cases.append(encode_case("encode_main_path", x_main, cfg, False, 0, reps=20))
    cases.append(encode_case("encode_main_path_stochastic", x_main, cfg, True, 0, reps=20))

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


def load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:      # a script may import a sibling
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(name, os.path.join(scripts, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_floor_script():
    """scripts/bench_torch_fused_render_floor.py as a module."""
    return load_script("bench_torch_fused_render_floor")


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


def tiny_serve_inputs(dev):
    """The tiny serving check's weights, grid (sparse, so compaction sees
    a real mask), batch of SERVE_BATCH and draws, made on the CPU (the same
    numbers in every process) and moved to ``dev``."""
    import torch

    from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
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
    return (tree_map(lambda x: x.to(dev), params),
            OccupancyGridState(*(t.to(dev) for t in grid)),
            {k: v.to(dev) for k, v in batch.items()},
            {k: v.to(dev) for k, v in draws.items()})


def serve_errors(got, want):
    """Each result key's largest difference over the key's largest
    reference entry (SSIM, a mean over [-1, 1] near 0 here, absolutely)."""
    return {k: float((got[k].float().cpu() - ref.float().cpu()).abs().max()
                     / (1.0 if k == "ssim" else ref.float().abs().max().clamp_min(1e-30)))
            for k, ref in want.items()}


def serve_parity(dev):
    """The tiny inference step (5 DDIM steps, float32, a sparse occupancy
    grid so compaction sees a real mask) on ``dev`` against the CPU, same
    params and draws.  Tolerance: every result key within 1e-3 of its
    largest reference entry (SSIM, a mean over [-1, 1] that is near 0
    here, within 1e-3 absolutely); float32 sums in other orders, through
    five U-Net passes and the VAE decode."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training.inference import make_inference_step

    cfg = tiny_joint_config()
    cpu = torch.device("cpu")
    results = {}
    for d in (cpu, dev):
        params, grid, batch, draws = tiny_serve_inputs(d)
        step = make_inference_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device=d),
                                   5, compute_dtype=torch.float32, guidance_scale=3.0,
                                   capture_attn_maps=True, device=d)
        out = step(params, grid, batch, draws=draws)
        out["ip_attn_maps"] = torch.cat([m.reshape(-1) for m in out["ip_attn_maps"]])
        results[d.type] = {k: v.float().cpu() for k, v in out.items()}
    errs = serve_errors(results[dev.type], results["cpu"])
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


class StageClock:
    """A ``stage_hook`` that synchronizes and reads the host clock at each
    stage's end; :meth:`request` times one request by stage."""

    def __init__(self, dev):
        self.dev, self.marks = dev, []

    def __call__(self, name):
        import torch

        torch.cuda.synchronize(self.dev)
        self.marks.append((name, time.perf_counter()))

    def request(self, step, *args, **kw):
        """(result, host ms, ms by stage) of one call of ``step``, built
        with this clock as its stage hook."""
        import torch

        self.marks.clear()
        torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        out = step(*args, **kw)
        torch.cuda.synchronize(self.dev)
        total = (time.perf_counter() - t0) * 1e3
        stages, prev = {}, t0
        for name, t in self.marks:
            stages[name] = (t - prev) * 1e3
            prev = t
        return out, total, stages


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
    hook = StageClock(dev)

    def request(step, batch):
        return hook.request(step, params, grid, batch, generator=g)

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


def host_rss_peak() -> int:
    """This process's peak resident set so far, bytes (``ru_maxrss``)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def sdxl_state_dicts(cfg, dev, seed):
    """A full-width SDXL directory's state dicts, drawn from ``seed``: the
    U-Net without IP heads (stock SDXL), the VAE and both CLIP text towers,
    in diffusers / transformers naming, on the card."""
    from stable_nerf_tpu_torch.models.diffusion import clip_text, weights
    from stable_nerf_tpu_torch.models.diffusion.sd_network import sd_network_init

    sd = sd_network_init(seed, cfg.sd, device=dev)
    return {"unet": weights.export_unet_state_dict(sd["unet"], cfg.sd.unet, include_ip=False),
            "vae": weights.export_vae_state_dict(sd["vae"], cfg.sd.vae),
            "text_encoder": clip_text_state_dict(clip_text.clip_text_init(
                seed + 1, clip_text.clip_l_config(), device=dev)),
            "text_encoder_2": clip_text_state_dict(clip_text.clip_text_init(
                seed + 2, clip_text.open_clip_bigg_config(), device=dev))}


def pretrained(dev, cfg, ckpt_dir):
    """The pretrained-weights path at full width: write an SDXL directory
    (U-Net, VAE, CLIP-L and bigG text towers; float16, seed 7, not the
    loop's seed 0) through the port's writer; time the header precheck,
    the fingerprint and ``load_sdxl`` onto the host (peak host RSS); run
    the empty-prompt conditioning on the card and on the CPU; build the
    joint params with the weights.  Every frozen leaf must equal the
    exported value rounded float16 → float32 → bfloat16 bit for bit, the
    IP heads the exported to_k/to_v in float32; the frozen leaves must
    differ from the seed-0 init's; the device peaks of the build with and
    without the weights are reported.  The directory stays for the cli
    phase.

    Tolerance of the conditioning, card against CPU: 1e-4 of each
    output's largest magnitude (float32 sums in other orders through 12
    and 32 layers)."""
    import shutil

    import torch

    from stable_nerf_tpu_torch.models.diffusion import clip_text, weights
    from stable_nerf_tpu_torch.training import loop
    from stable_nerf_tpu_torch.training.joint import joint_trainable_mask
    from stable_nerf_tpu_torch.utils.tree import partition, tree_map

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    parts = sdxl_state_dicts(cfg, dev, PRETRAINED_SEED)
    n_params = {k: sum(v.numel() for v in sd.values()) for k, sd in parts.items()}
    write_sdxl_checkpoint(ckpt_dir, parts, dtype=torch.float16)
    write_s = time.perf_counter() - t
    del parts
    torch.cuda.empty_cache()

    # load onto the host, as the CLI does
    rss_before = host_rss_peak()
    t = time.perf_counter()
    has_ip = weights.precheck_sdxl_checkpoint(ckpt_dir, cfg.sd.unet, cfg.sd.vae)
    precheck_s = time.perf_counter() - t
    t = time.perf_counter()
    fp = weights.checkpoint_fingerprint(ckpt_dir)
    fingerprint_s = time.perf_counter() - t
    t = time.perf_counter()
    pre = weights.load_sdxl(ckpt_dir, with_ip=has_ip, unet_cfg=cfg.sd.unet,
                            vae_cfg=cfg.sd.vae, device="cpu")
    load_s = time.perf_counter() - t
    rss_peak = host_rss_peak()

    # the empty-prompt conditioning: card (second call timed) against CPU
    towers = [tree_map(lambda x: x.to(dev), pre[k]) for k in ("text_encoder", "text_encoder_2")]
    cond_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = clip_text.make_empty_prompt_conditioning(*towers)
        torch.cuda.synchronize()
        cond_ms.append((time.perf_counter() - t) * 1e3)
    del towers
    t = time.perf_counter()
    host = clip_text.make_empty_prompt_conditioning(pre["text_encoder"], pre["text_encoder_2"])
    cond_cpu_s = time.perf_counter() - t
    cond_err = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(card, host)]

    # the joint params without, then with, the weights
    def frozen_sums(params):
        """{path: Σ|x|} of the frozen leaves."""
        mask = joint_trainable_mask(params, cfg.train.trainable_scope)
        leaves = [(p, x) for p, x in weights._leaves_with_path(partition(params, mask)[1])
                  if x is not None]
        sums = torch.stack([x.double().abs().sum() for _, x in leaves]).tolist()
        return dict(zip([p for p, _ in leaves], sums))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = loop.build_initial_params(cfg, SEED, SEED + 1, device=dev)
    torch.cuda.synchronize()
    build_random_s = time.perf_counter() - t
    peak_random = torch.cuda.max_memory_allocated(dev)
    random_sums = frozen_sums(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    t = time.perf_counter()
    params = loop.build_initial_params(cfg, SEED, SEED + 1, pre, device=dev,
                                       log_fn=logs.append)
    torch.cuda.synchronize()
    build_pretrained_s = time.perf_counter() - t
    peak_pretrained = torch.cuda.max_memory_allocated(dev)
    del pre

    # every frozen leaf against the exported values, drawn again from the seed
    sd = params["sd"]
    ref = sdxl_state_dicts(cfg, dev, PRETRAINED_SEED)
    got = {"unet": weights.export_unet_state_dict(sd["unet"], cfg.sd.unet),
           "vae": weights.export_vae_state_dict(sd["vae"], cfg.sd.vae)}
    checked, mismatched = 0, []
    for part in ("unet", "vae"):
        for key, value in got[part].items():
            base = key.replace("to_k_ip", "to_k").replace("to_v_ip", "to_v")
            want = ref[part][base].to(torch.float16).float()
            if value.dtype == torch.bfloat16:
                want = want.to(torch.bfloat16)
            checked += 1
            if value.dtype != want.dtype or not torch.equal(value, want):
                mismatched.append(f"{part}/{key}")
    del ref, got
    pooled_err = float((sd["add_text_embeds"].float() - card[1]).abs().max()
                       / card[1].abs().max())
    loaded_sums = frozen_sums(params)
    # every random leaf (a kernel) must differ from the seed-0 init's; norm
    # scales and zero biases are equal in any init
    kernels = [p for p in loaded_sums if p.endswith("['kernel']")]
    same = [p for p in kernels if loaded_sums[p] == random_sums[p]]
    del params, sd
    torch.cuda.empty_cache()

    total = fp["total_bytes"]
    row = {
        "phase": "pretrained", "seed": PRETRAINED_SEED, "dtype": "float16",
        "parameters": n_params, "files": fp["n_files"], "bytes": total, "has_ip": has_ip,
        "write_s": write_s, "precheck_s": precheck_s, "fingerprint_s": fingerprint_s,
        "load_s": load_s, "load_gb_per_s": total / load_s / 1e9,
        "host_rss_peak_before_load": rss_before, "host_rss_peak_after_load": rss_peak,
        "conditioning_ms_card": cond_ms, "conditioning_s_cpu": cond_cpu_s,
        "conditioning_rel_err": cond_err, "conditioning_tolerance": 1e-4,
        "add_text_embeds_rel_err_bf16": pooled_err,
        "build_s": {"random": build_random_s, "pretrained": build_pretrained_s},
        "max_memory_allocated": {"random": peak_random, "pretrained": peak_pretrained},
        "leaves_checked": checked, "leaves_mismatched": mismatched[:10],
        "frozen_leaves": len(loaded_sums), "frozen_kernels": len(kernels),
        "frozen_kernels_equal_to_seed0": same[:10],
        "log": logs, "fingerprint": fp["digest"],
    }
    row["ok"] = bool(
        not has_ip and checked > 2000 and not mismatched and max(cond_err) <= 1e-4
        and pooled_err <= 2 ** -7
        and len(kernels) > 500 and not same and card[1].abs().max() > 0)
    return row


CLI_RUNNER = """
import json, os, runpy, sys
from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
target = sys.argv[1]
hash_scatter_add_per_level.launches = 0
try:
    if target.endswith(".py"):
        sys.argv = sys.argv[1:]
        sys.path.insert(0, os.path.dirname(os.path.abspath(target)))
        runpy.run_path(target, run_name="__main__")
    else:
        sys.argv = [target] + sys.argv[2:]
        runpy.run_module(target, run_name="__main__", alter_sys=True)
finally:
    import torch
    print(json.dumps({"cli_counts": {
        "scatter_launches": hash_scatter_add_per_level.launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated()
        if torch.cuda.is_available() else None}}), flush=True)
"""


def run_cli(here, argv, timeout, target="stable_nerf_tpu_torch.train"):
    """``python -m stable_nerf_tpu_torch.train ARGV`` (or the script
    ``target``, a path ending in .py) in a process of its own, with the
    scatter kernel's launch count set to 0 before and read after (and the
    process's peak device memory; not its peak host RSS, which Linux
    carries over from this process across the exec).  Returns (row,
    stdout)."""
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_RUNNER, target, *argv], cwd=here,
                         capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    counts = next((json.loads(line)["cli_counts"] for line in reversed(lines)
                   if line.startswith('{"cli_counts"')), {})
    if out.returncode:
        print(out.stdout[-4000:] + out.stderr[-4000:], file=sys.stderr)
    return {"rc": out.returncode, "s": time.perf_counter() - t, **counts,
            "tail": [line for line in lines if not line.startswith('{"cli_counts"')][-3:]
            }, out.stdout


def cli(here, ckpt_dir):
    """``python -m stable_nerf_tpu_torch.train`` on the card.  (1) A tiny
    one-epoch run over the synthetic scene, then ``--inference`` on its
    workdir.  (2) At full width: a synthetic ``objaverse/views_release``
    (10 objects of 12 RGBA 512² PNGs and poses, cut from the committed
    synthetic scene) and the ``pretrained`` phase's SDXL directory, one
    epoch with ``--sdxl-checkpoint --frozen-bf16
    --checkpoint-trainable-only``, then ``--inference`` with the same
    checkpoint: the objaverse load's seconds an object, the epoch's steps,
    the scatter launches (16 a dense step), the inference's PSNR (finite;
    seeded weights make its value meaningless)."""
    import glob
    import re
    import shutil

    import torch

    workdir = os.path.join(here, "chiprun_out", "cli")
    shutil.rmtree(workdir, ignore_errors=True)
    common = ["--tiny", "--dataset", "synthetic", "--image-size", "32", "--latent-size", "16",
              "--workdir", workdir]
    runs = {name: run_cli(here, common + extra, timeout=600)[0]
            for name, extra in (("train", ["--epochs", "1"]), ("inference", ["--inference"]))}
    renders = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(workdir, "renders", "denoised_*")))
    row = {"phase": "cli", "runs": runs, "metrics_jsonl": os.path.exists(
               os.path.join(workdir, "metrics.jsonl")),
           "checkpoints": sorted(os.listdir(os.path.join(workdir, "checkpoints")))
           if os.path.isdir(os.path.join(workdir, "checkpoints")) else [],
           "renders": renders}
    tiny_ok = bool(all(r["rc"] == 0 for r in runs.values()) and row["metrics_jsonl"]
                   and row["checkpoints"] and renders)

    # full width: objaverse-layout data and the pretrained SDXL directory
    data = os.path.join(here, "chiprun_out", "datasets")
    full_dir = os.path.join(here, "chiprun_out", "cli_objaverse")
    shutil.rmtree(full_dir, ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    t = time.perf_counter()
    write_objaverse(data, OBJAVERSE_OBJECTS, 512)
    write_s = time.perf_counter() - t
    argv = ["--dataset", "objaverse", "--data-root", data, "--percent-objects", "1",
            "--sdxl-checkpoint", ckpt_dir, "--frozen-bf16", "--checkpoint-trainable-only",
            "--epochs", "1", "--workdir", full_dir, "--seed", str(SEED)]
    (full_train, train_log), (full_infer, infer_log) = (
        run_cli(here, argv + extra, timeout=900) for extra in ([], ["--inference"]))
    full = {"train": full_train, "inference": full_infer}
    loaded = re.search(r"dataset: (\d+) paired samples in ([\d.]+) s", train_log)
    epoch = re.search(r"epoch 0: train \S+ val \S+ \(\d+ rays/s, (\d+) steps in ([\d.]+) s\)",
                      train_log)
    psnr = [float(v) for v in re.findall(r"PSNR (\S+)", infer_log)]
    steps = int(epoch.group(1)) if epoch else 0
    n_loaded = int(loaded.group(1)) if loaded else 0
    load_s = float(loaded.group(2)) if loaded else math.nan
    row["objaverse"] = {
        "objects": OBJAVERSE_OBJECTS, "png_side": 512, "write_s": write_s,
        "objects_loaded": n_loaded, "load_s": load_s,
        "load_s_per_object": load_s / max(n_loaded, 1),
        "loader_threads": min(32, (os.cpu_count() or 1) + 4),
        "epoch_steps": steps, "epoch_train_s": float(epoch.group(2)) if epoch else None,
        "expected_launches": 16 * steps, "psnr": psnr,
        "runs": full,
        "sdxl_log": [line for line in train_log.splitlines() if "SDXL" in line
                     or "conditioning" in line],
    }
    full_ok = bool(all(r["rc"] == 0 for r in full.values()) and n_loaded == OBJAVERSE_OBJECTS
                   and steps > 0 and full["train"].get("scatter_launches") == 16 * steps
                   and psnr and all(math.isfinite(p) for p in psnr))
    row["ok"] = tiny_ok and full_ok
    shutil.rmtree(data, ignore_errors=True)
    shutil.rmtree(full_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def trained_rows_case(fit, args, out, dev):
    """K1 on one chunk of the fit's backward after its last step: the
    [2^17, 16, 8] rows and pair updates of a learned, sparse grid, captured
    at the encode's call of the wrapper (one more step at lr 0, after the
    launch count was read), held against the plain version as every
    scatter case is, with each level's distinct rows, the atomics left
    after merging and the share of zero updates (samples past the grid's
    occupied cells get a zero cotangent)."""
    import torch

    from stable_nerf_tpu_torch.ops import encoding
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    cfg = fit.nerf_config(args)
    captured = []
    wrapper = encoding.hash_scatter_add_per_level

    def record(idx, upd, *a, **kw):
        if not captured:
            captured.append((idx.clone(), upd.clone()))
        return wrapper(idx, upd, *a, **kw)

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    views = out["views"]
    n_pool = views["pool_o"].shape[0]
    encoding.hash_scatter_add_per_level = record
    try:
        fit.train_step(out["params"], torch.optim.SGD(tree_leaves(out["params"]), lr=0.0),
                       None, out["state"], views, cfg,
                       torch.randint(0, n_pool, (args.rays_per_batch,), generator=g,
                                     device=dev),
                       torch.rand(args.rays_per_batch, generator=g, device=dev),
                       bg=args.bg, max_steps=args.max_steps, loss=args.loss, budget=None)
    finally:
        encoding.hash_scatter_add_per_level = wrapper
    idx, upd = captured[0]
    hg = cfg.encoding_sigma
    case = scatter_case("i_fit_trained_rows", idx, upd, hg.n_levels, hg.table_size,
                        False, reps=20)
    case["distinct_rows_by_level"] = [int(torch.unique(idx[:, l]).numel())
                                      for l in range(hg.n_levels)]
    case["atomics_after_merging"] = sum(merged_atomics(idx[:, l]) for l in range(hg.n_levels))
    case["zero_update_share"] = float((upd == 0).all(-1).float().mean())
    return case


def fit_nerf(here, dev):
    """scripts/fit_torch_nerf.py's ``run`` at its defaults (128², 4,096
    rays a step, 256 march steps, exact encode, dense) for FIT_STEPS
    steps: s a step, K1 launches (8 a step run in Python: 2^20 samples in
    chunks of 2^17; the steps replayed from the fit step's CUDA graph
    launch theirs inside the graph, so the wrapper counts 8 an eager step
    and 8 a capture), the loss at the start and the end, the 8-view mean
    PSNR before the first step (after the first refresh) and after the
    last, which must be higher, peak memory; then the trained-rows K1
    case."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.utils import profiling

    fit = load_script("fit_torch_nerf")
    args = fit.build_parser().parse_args([
        "--steps", str(FIT_STEPS), "--log-every", str(FIT_STEPS + 1),
        "--data-root", os.path.join(here, "datasets"),
        "--out", os.path.join(here, "chiprun_out", "fit_nerf")])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hash_scatter_add_per_level.launches = 0
    profiling.reset_spans()
    with profiling.tracing():
        out = fit.run(args, dev, log=lambda line: print(line, file=sys.stderr, flush=True),
                      start_psnr=True)
    counts = profiling.counters()
    profiling.reset_spans()
    launches = hash_scatter_add_per_level.launches
    replays, captures = counts.get("fit.graph_replays", 0), counts.get("fit.graph_captures", 0)
    peak = torch.cuda.max_memory_allocated()
    case = trained_rows_case(fit, args, out, dev)
    start, end = statistics.mean(out["start_psnr"]), statistics.mean(out["psnr"])
    losses = out["losses"]
    row = {"phase": "fit_nerf", "steps": FIT_STEPS, "size": args.size,
           "rays_per_step": args.rays_per_batch, "max_steps": args.max_steps,
           "s_per_step": out["train_s"] / FIT_STEPS, "train_s": out["train_s"],
           "scatter_launches": launches, "scatter_launches_per_step": launches / FIT_STEPS,
           "graph_replays": replays, "graph_captures": captures,
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_last_10_mean": statistics.mean(losses[-10:]),
           "psnr_start": out["start_psnr"], "psnr_end": out["psnr"],
           "psnr_start_mean": start, "psnr_end_mean": end,
           "final_line": fit.final_line(out["psnr"]),
           "max_memory_allocated": peak, "i_fit_trained_rows": case}
    row["ok"] = bool(all(math.isfinite(x) for x in losses)
                     and launches == 8 * (FIT_STEPS - replays + captures)
                     and math.isfinite(end) and end > start and case["ok"])
    del out
    torch.cuda.empty_cache()
    return row, case


def demo(here, dev):
    """The learned-diffusion demo on the committed JAX-trained tiny VAE:
    the artifact loads onto the card and its VAE(white) latent background
    equals the JAX package's float32 value within 1e-3; then
    ``python -m stable_nerf_tpu_torch.train --dataset synthetic --demo
    --vae-checkpoint runs/demo_vae/vae.npz`` for DEMO_EPOCHS epochs at the
    JAX run's batch 8 and lrs, then ``--inference`` on its workdir (under
    .cache/, removed after): per-epoch losses, s an epoch, K1 launches (8
    a step), the inference's PSNR (finite), the peak."""
    import re
    import shutil

    import torch

    from stable_nerf_tpu_torch import train as cli_mod
    from stable_nerf_tpu_torch.models.diffusion.vae import vae_load_npz

    t = time.perf_counter()
    vae, vae_cfg, meta = vae_load_npz(os.path.join(here, DEMO_VAE), device=dev)
    load_s = time.perf_counter() - t
    args = cli_mod.build_parser().parse_args(["--demo", "--vae-checkpoint", DEMO_VAE])
    cli_mod.apply_demo_defaults(args)
    bg = cli_mod.latent_background(vae, cli_mod.build_config(args, vae_cfg), dev)
    bg_err = max(abs(a - b) for a, b in zip(bg, DEMO_BG_F32))
    del vae
    workdir = os.path.join(here, ".cache", "chip_smoke_demo")
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["--dataset", "synthetic", "--demo", "--vae-checkpoint", DEMO_VAE,
            "--batch-size", "8", "--lr", "1e-3", "--nerf-lr", "1e-2", "--val-every", "10",
            "--inference-every", "100", "--checkpoint-every", "0", "--seed", str(SEED),
            "--workdir", workdir]
    try:
        (train_row, train_log), (infer_row, infer_log) = (
            run_cli(here, argv + extra, timeout=600)
            for extra in (["--epochs", str(DEMO_EPOCHS)], ["--inference"]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    epochs = [(float(a), int(b), float(c)) for a, b, c in re.findall(
        r"epoch \d+: train (\S+) val \S+ \(\d+ rays/s, (\d+) steps in ([\d.]+) s\)",
        train_log)]
    steps = sum(e[1] for e in epochs)
    psnr = [float(v) for v in re.findall(r"PSNR (\S+)", infer_log)]
    printed_bg = re.search(r"latent background from VAE\(white\): (\[.*\])", train_log)
    row = {"phase": "demo", "vae": DEMO_VAE, "vae_config": list(vae_cfg.block_out_channels),
           "scaling_factor": vae_cfg.scaling_factor, "vae_load_s": load_s,
           "recon_psnr_test": meta.get("recon_psnr_test"),
           "background": list(bg), "background_vs_jax_f32_max_abs": bg_err,
           "background_vs_tpu_log_max_abs": max(abs(a - b)
                                                for a, b in zip(bg, DEMO_BG_TPU_LOG)),
           "background_tolerance": 1e-3,
           "cli_background": printed_bg.group(1) if printed_bg else None,
           "epochs": DEMO_EPOCHS, "epoch_train_losses": [e[0] for e in epochs],
           "epoch_steps": [e[1] for e in epochs], "epoch_train_s": [e[2] for e in epochs],
           "s_per_step": sum(e[2] for e in epochs) / max(steps, 1),
           "scatter_launches": train_row.get("scatter_launches"),
           "expected_launches": 8 * steps, "psnr": psnr,
           "runs": {"train": train_row, "inference": infer_row}}
    row["ok"] = bool(bg_err <= 1e-3 and train_row["rc"] == 0 and infer_row["rc"] == 0
                     and len(epochs) == DEMO_EPOCHS and steps > 0
                     and all(math.isfinite(e[0]) for e in epochs)
                     and train_row.get("scatter_launches") == 8 * steps
                     and psnr and all(math.isfinite(p) for p in psnr))
    torch.cuda.empty_cache()
    return row


def last_json(stdout, key):
    """The last line of ``stdout`` that is a JSON object holding ``key``."""
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if key in obj:
                return obj
    return {}


def sd_scripts(here, ckpt_dir):
    """scripts/validate_torch_sdxl_checkpoint.py and scripts/run_torch_sd.py
    on the pretrained phase's SDXL directory (seeded weights), each in a
    process of its own, and the check half of
    scripts/weights_torch_drill_full_size.py in this one (it must find the
    round trip bit-identical).  The validator's checksums are reported; every
    check must pass but the VAE's reconstruction PSNR above 20 dB, which a
    random VAE fails by design (its PSNR must be finite).  run_torch_sd's
    reconstruction MSE must be finite and its denoised image written
    (``.png.npy`` where PIL is absent)."""
    import re
    import shutil

    out = os.path.join(here, "chiprun_out", "sd_scripts")
    shutil.rmtree(out, ignore_errors=True)
    scripts = os.path.join(here, "scripts")
    val, val_log = run_cli(here, ["--checkpoint", ckpt_dir, "--out",
                                  os.path.join(out, "validate")], timeout=900,
                           target=os.path.join(scripts, "validate_torch_sdxl_checkpoint.py"))
    report = {}
    path = os.path.join(out, "validate", "report.json")
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
    sd, sd_log = run_cli(here, ["--sdxl-checkpoint", ckpt_dir, "--steps", "50", "--out",
                                os.path.join(out, "run_sd")], timeout=900,
                         target=os.path.join(scripts, "run_torch_sd.py"))
    mse = re.search(r"VAE reconstruction MSE: (\S+)", sd_log)
    rates = [float(v) for v in re.findall(r"\(([\d.]+) steps/s", sd_log)
             + re.findall(r"steady-state: ([\d.]+) denoise steps/s", sd_log)]
    images = sorted(f for f in os.listdir(os.path.join(out, "run_sd"))
                    if f.startswith("denoised.png")) if os.path.isdir(
                        os.path.join(out, "run_sd")) else []
    psnr = report.get("vae", {}).get("reconstruction_psnr_db")
    # the weights drill's check half on the same full-width directory: strict
    # load on the host, export, float16 bits against the bytes on disk
    t = time.perf_counter()
    drill = load_script("weights_torch_drill_full_size").check(ckpt_dir)
    drill["s"] = time.perf_counter() - t
    gc.collect()
    row = {"phase": "sd_scripts", "weights_drill_check": drill,
           "validate": {"rc": val["rc"], "s": val["s"], "report": report,
                        "tail": val["tail"]},
           "run_sd": {"rc": sd["rc"], "s": sd["s"], "mse": float(mse.group(1)) if mse else None,
                      "steps_per_s_cold_steady": rates, "images": images, "tail": sd["tail"]},
           "expected_failed_checks": ["vae_reconstruction_psnr"]}
    row["ok"] = bool(
        val["rc"] == 1 and report.get("failed_checks") == ["vae_reconstruction_psnr"]
        and psnr is not None and math.isfinite(psnr)
        and all(f"checksum/{k}" in report for k in ("unet", "vae", "text_encoder",
                                                   "text_encoder_2"))
        and sd["rc"] == 0 and mse and math.isfinite(float(mse.group(1))) and images
        and drill["bit_identical"])
    return row


def profile_sd(here):
    """scripts/profile_torch_sd_denoise.py --steps 3: the denoise step's
    device time by bucket, its idle share and its analytic MFU (the trace
    under .cache/, removed after)."""
    import shutil

    out_dir = os.path.join(here, ".cache", "chip_smoke_profile_sd")
    run, stdout = run_cli(here, ["--steps", "3", "--outdir", out_dir], timeout=600,
                          target=os.path.join(here, "scripts", "profile_torch_sd_denoise.py"))
    shutil.rmtree(out_dir, ignore_errors=True)
    rec = last_json(stdout, "buckets_ms_per_step")
    row = {"phase": "profile_sd", "rc": run["rc"], "s": run["s"], **rec}
    row["ok"] = bool(run["rc"] == 0 and rec.get("device_busy_ms_per_step", 0) > 0
                     and 0 <= rec.get("device_idle_share", -1) < 1
                     and rec.get("mfu_analytic") and 0 < rec["mfu_analytic"] <= 1)
    return row


def profile_step(state, out_dir, what):
    """One more call of a step (``what``: "joint_step" or "serve_request")
    under torch.profiler: device time by kernel name, the busy share of the
    call's wall time, and the full table in out_dir."""
    import torch

    from stable_nerf_tpu_torch.utils.profiling import (chrome_trace_intervals, device_time,
                                                       trace)

    step, params, grid, batch, g = state
    torch.cuda.synchronize()
    with trace(out_dir, what):
        t = time.perf_counter()
        step(params, grid, batch, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the table below keeps what is read; the trace itself (hundreds of
    # thousands of events for a serving request) is not kept
    trace_path = os.path.join(out_dir, what + ".json")
    dt = device_time(chrome_trace_intervals(trace_path))
    os.remove(trace_path)
    table = dt["kernels"]
    path = os.path.join(out_dir, what + "_kernels.json")
    with open(path, "w") as f:
        json.dump({"wall_ms": wall_ms, "device_busy_ms": dt["busy_ms"],
                   "launches": dt["launches"], "kernels_ms_count": table}, f, indent=1)
    return {"phase": "profile", "of": what, "wall_ms": wall_ms,
            "device_busy_ms": dt["busy_ms"],
            "device_idle_share": 1.0 - dt["busy_ms"] / wall_ms,
            "kernel_ms_sum": sum(r[1] for r in table), "launches": dt["launches"],
            "top": [[n[:90], ms, c] for n, ms, c in table[:12]],
            "table": path}


# -- training across processes ----------------------------------------------

RANKS = 2                # two ranks on the one card, over gloo
RANK_STEPS = 2           # full-width steps a rank
RANK_TIMEOUT_S = 420     # the two-rank launch, all its parts
RANK_DEVICE = "cuda:0"   # both ranks' device: the one card


def flagship_config():
    """The flagship step's configuration: ``train.py --frozen-bf16`` at
    full width, trainable scope ``reference``."""
    from stable_nerf_tpu_torch.config import NeRFConfig, TrainConfig
    from stable_nerf_tpu_torch.models.diffusion.sd_network import SDNetworkConfig
    from stable_nerf_tpu_torch.training.joint import JointConfig

    return JointConfig(nerf=NeRFConfig(channel_dim=4), sd=SDNetworkConfig(),
                       train=TrainConfig(frozen_dtype="bfloat16", max_steps_train=256,
                                         trainable_scope="reference"))


def full_draws(cfg, dev, seed):
    """Injected draws of a full-width step of one scene (the same numbers
    for every variant that is compared)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    enc, b = cfg.latent_hw, 1
    return {"vae_eps": torch.randn((2 * b, 4, enc, enc), generator=g, device=dev),
            "noise": torch.randn((b, 4, enc, enc), generator=g, device=dev),
            "timesteps": torch.randint(0, 1000, (b,), generator=g, device=dev),
            "perturb": torch.rand((2 * b * enc * enc,), generator=g, device=dev)}


def timed_steps(step, params, grid, batch, steps, dev, draws=None, generator=None):
    """``steps`` calls of ``step``; (metrics, host ms of each, K1 launches)."""
    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level

    hash_scatter_add_per_level.launches = 0
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        m = step(params, grid, batch, generator=generator, draws=draws)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    return losses, times, hash_scatter_add_per_level.launches


def remat_phase(dev, cfg, joint):
    """The full-width step with ``UNetConfig.remat``: its loss against the
    plain step's on the same params and draws (forward and backward, no
    update), then 3 train steps: ms, peak memory, K1 launches."""
    import dataclasses

    import torch

    from stable_nerf_tpu_torch.training.joint import (forward_iteration, make_optimizer,
                                                      make_train_step)
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    rcfg = dataclasses.replace(cfg, sd=dataclasses.replace(
        cfg.sd, unet=dataclasses.replace(cfg.sd.unet, remat=True)))
    params, mask, grid, sched, batch = make_setup(cfg, dev, SEED)
    draws = full_draws(cfg, dev, SEED + 9)
    for p, m in zip(tree_leaves(params), tree_leaves(mask)):
        p.requires_grad_(bool(m) and p.is_floating_point())
    losses = {}
    for name, c in (("plain", cfg), ("remat", rcfg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, n, _ = forward_iteration(params, grid, batch, c, sched, draws=draws)
        (s + n).backward()
        torch.cuda.synchronize()
        losses[name] = {"sd_loss": float(s), "nerf_loss": float(n),
                        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        for p in tree_leaves(params):
            p.grad = None
    opt = make_optimizer(rcfg.train, params, mask)
    step = make_train_step(rcfg, sched, opt, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    ms, times, launches = timed_steps(step, params, grid, batch, JOINT_STEPS, dev,
                                      generator=g)
    peak = torch.cuda.max_memory_allocated(dev)
    rel = max(abs(losses["remat"][k] - losses["plain"][k]) / abs(losses["plain"][k])
              for k in ("sd_loss", "nerf_loss"))
    chunks = 2 * cfg.latent_hw ** 2 * cfg.train.max_steps_train // 2 ** 17
    row = {"phase": "remat", "losses_same_draws": losses, "loss_rel_err": rel,
           "tolerance": 1e-6, "step_ms": times, "steady_step_ms": statistics.median(times[1:]),
           "joint_train_steady_step_ms": joint["steady_step_ms"],
           "max_memory_allocated": peak,
           "joint_train_max_memory_allocated": joint["max_memory_allocated"],
           "scatter_launches": launches, "expected_launches": chunks * JOINT_STEPS,
           "losses": ms}
    row["ok"] = bool(rel <= 1e-6 and launches == chunks * JOINT_STEPS
                     and all(math.isfinite(v) for l in ms for v in l.values()))
    del params, opt, step, grid, batch, draws
    torch.cuda.empty_cache()
    return row


def dp_world1(dev, cfg, joint):
    """The full-width step through the data-parallel step at world 1 on
    NCCL: step ms against joint_train's, the bytes all-reduced a step, the
    all-reduce's ms on those gradients alone, K1 launches, peak memory."""
    import torch

    from stable_nerf_tpu_torch.parallel import (all_reduce_mean_, close_mesh, make_mesh,
                                                make_parallel_train_step)
    from stable_nerf_tpu_torch.training.joint import make_optimizer, make_train_step

    mesh = make_mesh(dev)
    try:
        params, mask, grid, sched, batch = make_setup(cfg, dev, SEED)
        opt = make_optimizer(cfg.train, params, mask)
        step = make_parallel_train_step(make_train_step(cfg, sched, opt, device=dev,
                                                        mesh=mesh), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.counts.update(all_reduce_bytes=0, all_reduce_calls=0)
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        losses, times, launches = timed_steps(step, params, grid, batch, JOINT_STEPS, dev,
                                              generator=g)
        peak = torch.cuda.max_memory_allocated(dev)
        counted = dict(mesh.counts)
        grads = [torch.ones_like(p) for grp in opt.param_groups for p in grp["params"]]
        reduce_ms = cuda_ms(lambda: all_reduce_mean_(grads, mesh), 5)
        chunks = 2 * cfg.latent_hw ** 2 * cfg.train.max_steps_train // 2 ** 17
        row = {"phase": "dp_train_world1", "backend": mesh.backend, "world": mesh.world,
               "step_ms": times, "steady_step_ms": statistics.median(times[1:]),
               "joint_train_steady_step_ms": joint["steady_step_ms"],
               "all_reduce_bytes_per_step": counted["all_reduce_bytes"] // JOINT_STEPS,
               "all_reduce_calls_per_step": counted["all_reduce_calls"] / JOINT_STEPS,
               "all_reduce_ms": reduce_ms,
               "scatter_launches": launches, "expected_launches": chunks * JOINT_STEPS,
               "max_memory_allocated": peak, "losses": losses}
        row["ok"] = bool(mesh.backend == "nccl" and launches == chunks * JOINT_STEPS
                         and all(math.isfinite(v) for l in losses for v in l.values()))
        del params, opt, step, grid, batch, grads
    finally:
        close_mesh()
    torch.cuda.empty_cache()
    return row


def tiny_rank_inputs(dev):
    """The tiny f32 parity's weights (built on the CPU, so every process
    holds the same numbers), a global batch of 2 and its draws."""
    import torch

    from stable_nerf_tpu_torch.utils.tree import tree_map

    cfg = tiny_joint_config()
    params, _, grid, _, _ = make_setup(cfg, torch.device("cpu"), SEED)
    g = torch.Generator().manual_seed(SEED + 11)
    batch = make_batch(cfg, torch.device("cpu"), g, RANKS)
    enc = cfg.latent_hw
    draws = {"vae_eps": torch.randn((2 * RANKS, 4, enc, enc), generator=g),
             "noise": torch.randn((RANKS, 4, enc, enc), generator=g),
             "timesteps": torch.tensor([417, 83]),
             "perturb": torch.rand((2 * RANKS * enc * enc,), generator=g)}
    to = lambda t: tree_map(lambda x: x.to(dev), t)     # noqa: E731
    return cfg, to(params), type(grid)(*(x.to(dev) for x in grid)), to(batch), to(draws)


def rows_of(tree, rank, world):
    """Rank ``rank``'s rows of a global batch or its draws (target and
    reference rows of its samples for the [2B, ...] draws)."""
    import torch

    out = {}
    for k, v in tree.items():
        b = v.shape[0] // (2 if k in ("vae_eps", "perturb") else 1)
        per = b // world
        if k in ("vae_eps", "perturb"):
            v2 = v.reshape(2 * b, -1)
            v = torch.cat([v2[rank * per:(rank + 1) * per],
                           v2[b + rank * per:b + (rank + 1) * per]]).reshape(
                (-1,) + tuple(v.shape[1:]))
        else:
            v = v[rank * per:(rank + 1) * per]
        out[k] = v
    return out


def tiny_reference(dev, mode):
    """One process's update on the global batch of 2 for ``mode``: dp, the
    mean of the two rows' gradients (two accumulated calls of one row: the
    data-parallel step pairs each rank's own rows); fsdp, the step on the
    batch of 2 (the fully-sharded step pairs over the global batch)."""
    import dataclasses

    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training.joint import (joint_trainable_mask, make_optimizer,
                                                      make_train_step)
    from stable_nerf_tpu_torch.utils.tree import partition, tree_map

    cfg, params, grid, batch, draws = tiny_rank_inputs(dev)
    if mode == "dp":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 grad_accum_steps=RANKS))
    mask = joint_trainable_mask(params)
    opt = make_optimizer(cfg.train, params, mask)
    step = make_train_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device=dev), opt,
                           compute_dtype=torch.float32, device=dev)
    if mode == "dp":
        ms = [step(params, grid, rows_of(batch, r, RANKS), draws=rows_of(draws, r, RANKS))
              for r in range(RANKS)]
        loss = {k: sum(float(m[k]) for m in ms) / RANKS for k in ms[0]}
    else:
        loss = {k: float(v) for k, v in step(params, grid, batch, draws=draws).items()}
    return loss, tree_map(lambda x: None if x is None else x.detach().cpu(),
                          partition(params, mask)[0])


def compare_updates(got, want, before, lr):
    """Each trainable leaf's update within 1e-3 of the reference's in L2
    norm (the color MLP's leaves, whose gradients sit near Adam's eps, held
    only to lr per entry); returns the worst relative error."""
    from stable_nerf_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

    worst = 0.0
    for (path, g), w, b in zip(tree_leaves_with_path(got), tree_leaves(want),
                               tree_leaves(before)):
        if g is None:
            continue
        upd = (w - b).double()
        err = float(((g - b).double() - upd).norm() / upd.norm().clamp_min(1e-30))
        if "color_mlp" in path:
            if float((g - w).abs().max()) > 2 * lr:
                return math.inf
            continue
        worst = max(worst, err)
    return worst


def rank_worker(outdir, argv):
    """One of the two ranks on the card (``--rank-worker``): the gloo probe
    on CUDA tensors, then (dp) the tiny f32 step on its row and the
    full-width steps, then (fsdp, where the probe passed) the same
    fully sharded; writes ``rank<r>.json`` and its tiny updates."""
    import torch
    import torch.distributed as dist

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.parallel import (close_mesh, make_mesh,
                                                make_parallel_train_step,
                                                place_joint_for_fsdp, replicate)
    from stable_nerf_tpu_torch.training.joint import (joint_trainable_mask, make_optimizer,
                                                      make_train_step)
    from stable_nerf_tpu_torch.utils.device import disable_tf32
    from stable_nerf_tpu_torch.utils.tree import partition, tree_leaves, tree_map

    disable_tf32()
    flag = lambda name: argv[argv.index(name) + 1]                 # noqa: E731
    dev = torch.device(RANK_DEVICE)
    # NCCL refuses two ranks on one card: gloo, named, carries CUDA tensors
    mesh = make_mesh(dev, backend="gloo", init_method=f"tcp://{flag('--coordinator')}",
                     rank=int(flag("--process-id")), world_size=int(flag("--num-processes")))
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend}
    try:
        probe = {}
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * mesh.rank
        for name, call in (
                ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                    torch.empty(4 * mesh.world, device=dev), x)),
                ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                    torch.empty(4 // mesh.world, device=dev), x))):
            try:
                call()
                torch.cuda.synchronize()
                probe[name] = "ok"
            except RuntimeError as e:                  # the backend lacks it
                probe[name] = str(e)[:300]
        out["probe"] = probe
        modes = ["dp"] + (["fsdp"] if all(v == "ok" for v in probe.values()) else [])
        for mode in modes:
            rec = {}
            # tiny f32 step on this rank's row
            cfg, params, grid, batch, draws = tiny_rank_inputs(dev)
            mask = joint_trainable_mask(params)
            layout = None
            if mode == "fsdp":
                params, layout = place_joint_for_fsdp(params, mesh, min_size=1 << 8)
            opt = make_optimizer(cfg.train, params, mask)
            step = make_parallel_train_step(make_train_step(
                cfg, DDIMScheduler.create(cfg.sd.scheduler, device=dev), opt,
                compute_dtype=torch.float32, device=dev, fsdp=layout,
                mesh=mesh), mesh)
            m = step(params, grid, rows_of(batch, mesh.rank, mesh.world),
                     draws=rows_of(draws, mesh.rank, mesh.world))
            rec["tiny_loss"] = {k: float(v) for k, v in m.items()}
            whole = layout.gather(params, with_grad=False) if layout else params
            if mesh.rank == 0:
                torch.save(tree_map(lambda t: None if t is None else t.detach().cpu(),
                                    partition(whole, mask)[0]),
                           os.path.join(outdir, f"tiny_{mode}.pt"))
            del params, opt, step, whole
            # full width
            full = flagship_config()
            params, mask, grid, sched, batch = make_setup(full, dev, SEED)
            replicate((params, list(grid)), mesh)
            layout = None
            if mode == "fsdp":
                params, layout = place_joint_for_fsdp(params, mesh)
                rec["sharded_leaves"] = len(layout.leaves)
            torch.cuda.empty_cache()
            opt = make_optimizer(full.train, params, mask)
            step = make_parallel_train_step(make_train_step(
                full, sched, opt, device=dev, mesh=mesh, fsdp=layout), mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            g = torch.Generator(device=dev).manual_seed(SEED + 4)
            losses, times, launches = timed_steps(step, params, grid, batch, RANK_STEPS,
                                                  dev, generator=g)
            torch.cuda.synchronize()
            rec.update(step_ms=times, losses=losses, scatter_launches=launches,
                       max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                       resting_bytes=torch.cuda.memory_allocated(dev),
                       param_bytes=sum(x.numel() * x.element_size()
                                       for x in tree_leaves(params)))
            out[mode] = rec
            del params, opt, step, grid, batch, layout
            torch.cuda.empty_cache()
    finally:
        with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
        close_mesh()
    return 0


def two_ranks(here, dev, cfg, dp1):
    """``dp_train`` and ``fsdp_train``: two processes on the one card over
    gloo (chip_smoke.py --rank-worker), checked against one process's
    updates on the global batch of 2 at the tiny f32 size."""
    import shutil

    import torch

    from stable_nerf_tpu_torch.train import launch_local

    outdir = os.path.join(here, "chiprun_out", "two_ranks")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    refs = {mode: tiny_reference(dev, mode) for mode in ("dp", "fsdp")}
    _, before, _, _, _ = tiny_rank_inputs(torch.device("cpu"))
    from stable_nerf_tpu_torch.training.joint import joint_trainable_mask
    from stable_nerf_tpu_torch.utils.tree import partition

    before = partition(before, joint_trainable_mask(before))[0]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rc = launch_local([], RANKS, command=[sys.executable, os.path.join(here, "chip_smoke.py"),
                                          "--rank-worker", outdir], timeout=RANK_TIMEOUT_S)
    wall = time.perf_counter() - t
    ranks = []
    for r in range(RANKS):
        path = os.path.join(outdir, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {})
    chunks = 2 * cfg.latent_hw ** 2 * cfg.train.max_steps_train // 2 ** 17
    rows = []
    lr = tiny_joint_config().train.lr
    for mode in ("dp", "fsdp"):
        recs = [r.get(mode) for r in ranks]
        row = {"phase": f"{mode}_train", "ranks": RANKS, "backend": "gloo",
               "launch_rc": rc, "launch_s": wall, "probe": ranks[0].get("probe")}
        if mode == "dp":
            row["world1_nccl"] = {k: dp1[k] for k in (
                "steady_step_ms", "joint_train_steady_step_ms", "all_reduce_bytes_per_step",
                "all_reduce_ms", "scatter_launches", "max_memory_allocated")}
        if all(recs):
            want_loss, want = refs[mode]
            got = torch.load(os.path.join(outdir, f"tiny_{mode}.pt"), weights_only=False)
            loss_err = max(abs(recs[0]["tiny_loss"][k] - want_loss[k]) / abs(want_loss[k])
                           for k in want_loss)
            upd_err = compare_updates(got, want, before, lr)
            row.update({
                "tiny_loss_rel_err": loss_err, "tiny_update_rel_err": upd_err,
                "tolerance": {"loss": 1e-5, "update_l2": 1e-3},
                "ranks_agree": recs[0]["tiny_loss"] == recs[1]["tiny_loss"],
                "per_rank": [{k: v for k, v in rec.items() if k != "losses"}
                             for rec in recs],
                "losses": recs[0]["losses"]})
            row["ok"] = bool(rc == 0 and loss_err <= 1e-5 and upd_err <= 1e-3
                             and row["ranks_agree"]
                             and all(rec["scatter_launches"] == chunks * RANK_STEPS
                                     for rec in recs)
                             and all(math.isfinite(v) for rec in recs
                                     for l in rec["losses"] for v in l.values()))
        else:
            row["ok"] = False
        rows.append(row)
    return rows


def cli_dp(here):
    """``python -m stable_nerf_tpu_torch.train --tiny --dataset synthetic
    --data-parallel --fsdp --remat`` for one epoch (one card: a world of
    one on NCCL), then ``--inference`` on its workdir."""
    import glob
    import re
    import shutil

    workdir = os.path.join(here, "chiprun_out", "cli_dp")
    shutil.rmtree(workdir, ignore_errors=True)
    common = ["--tiny", "--dataset", "synthetic", "--image-size", "32", "--latent-size", "16",
              "--workdir", workdir]
    (train_row, log), (infer_row, _) = (
        run_cli(here, common + extra, timeout=600)
        for extra in (["--data-parallel", "--fsdp", "--remat", "--epochs", "1"],
                      ["--inference"]))
    renders = glob.glob(os.path.join(workdir, "renders", "denoised_*"))
    lines = [line for line in log.splitlines() if "data parallel" in line or "fsdp:" in line]
    steps = [int(m) for m in re.findall(r"(\d+) steps in", log)]
    row = {"phase": "cli_dp", "runs": {"train": train_row, "inference": infer_row},
           "log": lines, "epoch_steps": steps,
           "metrics_jsonl": os.path.exists(os.path.join(workdir, "metrics.jsonl")),
           "renders": len(renders)}
    row["ok"] = bool(train_row["rc"] == 0 and infer_row["rc"] == 0 and renders
                     and any("over nccl, fully sharded" in line for line in lines)
                     and steps and train_row.get("scatter_launches", 0) > 0)
    return row


# -- model-axis parallelism: tensor- and sequence-parallel serving, TP training --

MODEL_TIMEOUT_S = 480    # a launch of the model-axis phases, all its parts
PROBE_TIMEOUT_S = 90     # the ring transport probe's launch
FSDP_TP_RANKS = 4        # data 2 x model 2, at the tiny size
# the full-width sharded request against the single-process one, both in
# bf16 through 50 DDIM steps: the sums of the sharded heads and the ring's
# online softmax round in other places, so the images are held on average
# (PSNR of one against the other), the tiny float32 request entry by entry
SERVE_PSNR_DB = 30.0
TINY_SERVE_TOL = 1e-3
MODEL_SERVE_STEPS = 10   # DDIM steps of the sharded full-width requests (the depth cut)


def param_checksum(tree) -> float:
    """A float64 sum of every leaf: equal weights give equal sums (each
    rank builds the flagship weights from the seed on its own)."""
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    return float(sum(x.double().sum() for x in tree_leaves(tree)
                     if x.is_floating_point()))


def serve_inputs(cfg, dev):
    """The full-width request's batch of SERVE_BATCH scenes and its draws,
    from a seed, on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = make_batch(cfg, dev, g, SERVE_BATCH)
    enc = cfg.latent_hw
    draws = {"vae_eps": torch.randn((SERVE_BATCH, 4, enc, enc), generator=g, device=dev),
             "init_latents": torch.randn((SERVE_BATCH, 4, enc, enc), generator=g,
                                         device=dev)}
    return batch, draws


def rank_mesh(dev, argv, sp=1, tp=1):
    """This rank's (data x seq x model) mesh over gloo, the world joined at
    the first call and adopted after."""
    from stable_nerf_tpu_torch.parallel import make_mesh_3d

    flag = lambda name: argv[argv.index(name) + 1]                 # noqa: E731
    return make_mesh_3d(dev, sp=sp, tp=tp, backend="gloo",
                        init_method=f"tcp://{flag('--coordinator')}",
                        rank=int(flag("--process-id")),
                        world_size=int(flag("--num-processes")))


def ring_probe_job(dev, argv, outdir):
    """gloo's point-to-point path handed CUDA tensors as they are (the ring
    stages its blocks through the host instead): what it returns."""
    import torch
    import torch.distributed as dist

    mesh = rank_mesh(dev, argv)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * mesh.rank
    recv = torch.empty_like(x)
    peer = 1 - mesh.rank
    ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, recv, peer)]
    try:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        got = "ok" if torch.equal(recv.cpu(), torch.arange(8.0) + 100 * peer) else \
            f"wrong values {recv.cpu().tolist()}"
    except RuntimeError as e:                    # the backend refuses them
        got = str(e)[:300]
    with open(os.path.join(outdir, f"probe{mesh.rank}.json"), "w") as f:
        json.dump({"gloo_p2p_cuda": got}, f)
    return mesh


def serve_job(dev, argv, outdir):
    """tp_serve, then sp_serve: the tiny float32 request (5 DDIM steps,
    guidance 3) and the full-width one (a 2-step warm-up, then
    MODEL_SERVE_STEPS steps) sharded, each rank's results written for the
    parent to compare."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training.inference import (make_inference_step,
                                                          make_sharded_inference_step)

    cfg = flagship_config()
    tiny = tiny_joint_config()
    t_params, t_grid, t_batch, t_draws = tiny_serve_inputs(dev)
    params, _, grid, sched, _ = make_setup(cfg, dev, SEED)
    batch, draws = serve_inputs(cfg, dev)
    rec = {"param_checksum": param_checksum(params)}
    mesh = None
    for name, sp, tp in (("tp_serve", 1, 2), ("sp_serve", 2, 1)):
        mesh = rank_mesh(dev, argv, sp=sp, tp=tp)
        r = {"mesh": mesh.shape}
        build = make_sharded_inference_step(
            tiny, DDIMScheduler.create(tiny.sd.scheduler, device=dev), 5, mesh=mesh, tp=tp,
            sp=sp, compute_dtype=torch.float32, guidance_scale=3.0)
        local, step = build(t_params)
        out = step(local, t_grid, t_batch, draws=t_draws)
        torch.save({k: v.cpu() for k, v in out.items()},
                   os.path.join(outdir, f"{name}_tiny_rank{mesh.rank}.pt"))
        del local, step, out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        clock = StageClock(dev)
        build = make_sharded_inference_step(cfg, sched, MODEL_SERVE_STEPS,
                                            mesh=mesh, tp=tp, sp=sp, stage_hook=clock)
        local, step = build(params)
        axes = dict(tp_axis=mesh.axes["model"] if tp > 1 else None,
                    sp_axis=mesh.axes["seq"] if sp > 1 else None)
        warm = make_inference_step(cfg, sched, 2, device=dev, **axes)
        warm(local, grid, batch, draws=draws)
        for k in list(mesh.counts):
            mesh.counts[k] = 0
        out, ms, stages = clock.request(step, local, grid, batch, draws=draws)
        r.update(request_ms=ms, stages_ms=stages, counts=dict(mesh.counts),
                 max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                 finite=bool(out["denoised_image"].isfinite().all()))
        torch.save(out["denoised_image"].cpu(),
                   os.path.join(outdir, f"{name}_rank{mesh.rank}.pt"))
        rec[name] = r
        del local, step, warm, out
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"serve{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    return mesh


def tp_train_job(dev, argv, outdir, fsdp=False):
    """tp_train (world 2: model 2) or fsdp_tp_train (world 4: data 2 x
    model 2, fully sharded over data): the tiny float32 step on this data
    rank's rows of the global batch of 2; for tp_train then RANK_STEPS
    full-width steps: ms, scatter launches, peak and resting bytes."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level
    from stable_nerf_tpu_torch.parallel import (make_parallel_train_step,
                                                place_joint_for_fsdp, place_joint_for_tp,
                                                replicate)
    from stable_nerf_tpu_torch.training.joint import (joint_trainable_mask, make_optimizer,
                                                      make_train_step)
    from stable_nerf_tpu_torch.utils.tree import partition, tree_leaves, tree_map

    mesh = rank_mesh(dev, argv, tp=2)
    data, model = mesh.axes["data"], mesh.axes["model"]
    name = "fsdp_tp_train" if fsdp else "tp_train"
    rec = {"mesh": mesh.shape}

    def place(params, mask, min_size):
        if fsdp:
            params, layout = place_joint_for_fsdp(params, data, tp_axis=model,
                                                  min_size=min_size)
            return params, layout, layout.tp
        params, tp = place_joint_for_tp(params, model)
        return params, None, tp

    cfg, params, grid, batch, draws = tiny_rank_inputs(dev)
    mask = joint_trainable_mask(params)
    params, layout, tp = place(params, mask, 1 << 8)
    opt = make_optimizer(cfg.train, params, mask)
    step = make_parallel_train_step(make_train_step(
        cfg, DDIMScheduler.create(cfg.sd.scheduler, device=dev), opt,
        compute_dtype=torch.float32, device=dev, mesh=data, fsdp=layout, tp_axis=model), data)
    hash_scatter_add_per_level.launches = 0
    m = step(params, grid, rows_of(batch, data.rank, data.world),
             draws=rows_of(draws, data.rank, data.world))
    rec["tiny_scatter_launches"] = hash_scatter_add_per_level.launches
    rec["tiny_loss"] = {k: float(v) for k, v in m.items()}
    whole = layout.gather(params, with_grad=False) if layout else params
    whole = tp.gather(whole)
    if mesh.rank == 0:
        torch.save(tree_map(lambda t: None if t is None else t.detach().cpu(),
                            partition(whole, mask)[0]),
                   os.path.join(outdir, f"tiny_{name}.pt"))
    del params, opt, step, whole, layout, tp
    if not fsdp:
        full = flagship_config()
        params, mask, grid, sched, batch = make_setup(full, dev, SEED)
        replicate((params, list(grid)), mesh)
        params, _, tp = place(params, mask, None)
        torch.cuda.empty_cache()
        opt = make_optimizer(full.train, params, mask)
        step = make_parallel_train_step(make_train_step(
            full, sched, opt, device=dev, mesh=data, tp_axis=model), data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in list(mesh.counts):
            mesh.counts[k] = 0
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        losses, times, launches = timed_steps(step, params, grid, batch, RANK_STEPS, dev,
                                              generator=g)
        torch.cuda.synchronize()
        rec.update(step_ms=times, losses=losses, scatter_launches=launches,
                   counts_per_step={k: v / RANK_STEPS for k, v in mesh.counts.items()},
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                   resting_bytes=torch.cuda.memory_allocated(dev),
                   param_bytes=sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
                   sharded_leaves=len(tp.leaves))
        del params, opt, step, grid, batch
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"{name}{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    return mesh


SD_SHARDED_STEPS = 3      # DDIM steps of run_sd_sharded's full-width denoise
SD_SHARDED_CASES = (("tp", 1, 2), ("sp", 2, 1))     # (name, sp, tp)
# the sharded latents against one process's, both bf16 through 3 steps:
# PSNR of the difference over the reference's peak.  The sharded serving
# request reads 77.8 dB against one process's image after 50 steps and the
# decode (PERF.md §6); the latents before any decode keep every rounding
# difference of the sharded sums (bf16's 2^-8 relative step), so they are
# held at 40 dB, well above what a wrong cut gives (a misplaced head or
# token block moves eps by its own size: under 20 dB)
SD_SHARDED_PSNR_DB = 40.0


def run_sd_inputs(dev):
    """run_torch_sd's full-width config, its seed-0 params (IP heads from
    to_k/to_v), start latents [1, 4, 64, 64] and zero conditioning, on
    ``dev``: every rank and the parent draw the same."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                                   sd_network_init)

    run_sd = load_script("run_torch_sd")
    cfg = run_sd.network_config(False, 512)
    params = init_ip_from_unet(sd_network_init(0, cfg, device=dev))
    enc = cfg.sd.latent_size
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    latents = torch.randn((1, 4, enc, enc), generator=g, device=dev)
    cond = torch.zeros((2, cfg.sd.cond_channels, enc, enc), device=dev)
    return run_sd, cfg, params, latents, cond, DDIMScheduler.create(cfg.scheduler, device=dev)


def run_sd_job(dev, argv, outdir):
    """run_sd_sharded: run_torch_sd's sharded denoise, tp 2 then sp 2, one
    warm-up step, then SD_SHARDED_STEPS timed; each rank's latents and
    counts written for the parent to compare."""
    import torch

    run_sd, cfg, params, latents, cond, sched = run_sd_inputs(dev)
    rec, mesh = {"param_checksum": param_checksum(params)}, None
    for name, sp, tp in SD_SHARDED_CASES:
        mesh = rank_mesh(dev, argv, sp=sp, tp=tp)
        local = run_sd.shard_params(params, mesh)
        run_sd.denoise(local, latents, cond, cfg, sched, 1, mesh=mesh)
        for k in list(mesh.counts):
            mesh.counts[k] = 0
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = run_sd.denoise(local, latents, cond, cfg, sched, SD_SHARDED_STEPS, mesh=mesh)
        torch.cuda.synchronize(dev)
        rec[name] = {"mesh": mesh.shape, "s_per_step": (time.perf_counter() - t)
                     / SD_SHARDED_STEPS, "counts": dict(mesh.counts),
                     "finite": bool(out.isfinite().all())}
        torch.save(out.float().cpu(), os.path.join(outdir, f"run_sd_{name}_rank{mesh.rank}.pt"))
        del local, out
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"run_sd{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    return mesh


RANK_JOBS = {"ring_probe": ring_probe_job, "serve": serve_job, "tp_train": tp_train_job,
             "fsdp_tp_train": lambda dev, argv, outdir: tp_train_job(dev, argv, outdir,
                                                                     fsdp=True),
             "run_sd": run_sd_job}


def model_job(outdir, argv, job):
    """One rank of a model-axis launch (``--rank-worker DIR --rank-job
    JOB``), on the one card over gloo."""
    import torch

    from stable_nerf_tpu_torch.parallel import close_mesh
    from stable_nerf_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    try:
        RANK_JOBS[job](torch.device(RANK_DEVICE), argv, outdir)
    finally:
        close_mesh()
    return 0


def launch_job(here, outdir, job, n, timeout, probe=False):
    """``n`` ranks of ``job``; (exit code, seconds).  A ``probe`` that
    outlives ``timeout`` is recorded as "timeout" (its ranks are stopped);
    any other job's timeout raises."""
    from stable_nerf_tpu_torch.train import launch_local

    t = time.perf_counter()
    command = [sys.executable, os.path.join(here, "chip_smoke.py"), "--rank-worker", outdir,
               "--rank-job", job]
    try:
        rc = launch_local([], n, command=command, timeout=timeout)
    except TimeoutError:
        if not probe:
            raise
        rc = "timeout"
    return rc, time.perf_counter() - t


def read_json(path):
    return json.load(open(path)) if os.path.exists(path) else {}


def model_axis(here, dev, cfg, served, dp_row):
    """tp_serve, sp_serve, tp_train and fsdp_tp_train: ranks of this script
    on the one card over gloo (NCCL refuses two ranks on one device), each
    checked against one process's result on the same weights and draws
    (the serving ones against a MODEL_SERVE_STEPS request on the seed's
    untrained weights, the serve phase's kernels already warm)."""
    import shutil

    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.training.joint import joint_trainable_mask
    from stable_nerf_tpu_torch.utils.tree import partition

    outdir = os.path.join(here, "chiprun_out", "model_axis")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    # one process's requests: the tiny float32 one and the full-width one
    tiny = tiny_joint_config()
    t_params, t_grid, t_batch, t_draws = tiny_serve_inputs(dev)
    tiny_ref = make_inference_step(tiny, DDIMScheduler.create(tiny.sd.scheduler, device=dev),
                                   5, compute_dtype=torch.float32, guidance_scale=3.0,
                                   device=dev)(t_params, t_grid, t_batch, draws=t_draws)
    params, _, grid, sched, _ = make_setup(cfg, dev, SEED)
    checksum = param_checksum(params)
    batch, draws = serve_inputs(cfg, dev)
    clock = StageClock(dev)
    step = make_inference_step(cfg, sched, MODEL_SERVE_STEPS, device=dev, stage_hook=clock)
    torch.cuda.reset_peak_memory_stats(dev)
    single, single_ms, single_stages = clock.request(step, params, grid, batch, draws=draws)
    single_img = single["denoised_image"].float().cpu()
    single_peak = torch.cuda.max_memory_allocated(dev)
    del params, grid, step, single, batch, draws
    torch.cuda.empty_cache()
    tiny_train_ref = tiny_reference(dev, "fsdp")
    _, before, _, _, _ = tiny_rank_inputs(torch.device("cpu"))
    before = partition(before, joint_trainable_mask(before))[0]
    torch.cuda.empty_cache()

    probe_rc, probe_s = launch_job(here, outdir, "ring_probe", RANKS, PROBE_TIMEOUT_S,
                                   probe=True)
    probe = [read_json(os.path.join(outdir, f"probe{r}.json")) for r in range(RANKS)]
    rows = []
    rc, wall = launch_job(here, outdir, "serve", RANKS, MODEL_TIMEOUT_S)
    ranks = [read_json(os.path.join(outdir, f"serve{r}.json")) for r in range(RANKS)]
    for name in ("tp_serve", "sp_serve"):
        row = {"phase": name, "ranks": RANKS, "backend": "gloo", "launch_rc": rc,
               "launch_s": wall, "scenes_per_request": SERVE_BATCH,
               "ddim_steps": MODEL_SERVE_STEPS,
               "single_process_request_ms": single_ms,
               "single_process_stages_ms": single_stages,
               "single_process_max_memory_allocated": single_peak,
               "serve_50_step_request_ms": served["steady_request_ms"]}
        if name == "sp_serve":
            row["ring_transport"] = "gloo, staged through host tensors"
            # a rank that aborts inside gloo writes nothing: its exit code says so
            row["ring_probe"] = {"launch_rc": probe_rc, "launch_s": probe_s,
                                 "gloo_p2p_cuda": [p.get("gloo_p2p_cuda",
                                                         f"no result: exited {probe_rc}")
                                                   for p in probe]}
        recs = [r.get(name) for r in ranks]
        paths = [os.path.join(outdir, f"{name}_rank{r}.pt") for r in range(RANKS)]
        if rc == 0 and all(recs) and all(map(os.path.exists, paths)):
            imgs = [torch.load(p).float() for p in paths]
            tiny_out = [torch.load(os.path.join(outdir, f"{name}_tiny_rank{r}.pt"))
                        for r in range(RANKS)]
            tiny_errs = serve_errors(tiny_out[0], tiny_ref)
            mse = float(((imgs[0] - single_img) ** 2).mean())
            row.update({
                "weights_equal": all(r["param_checksum"] == checksum for r in ranks),
                "ranks_bit_equal": all(torch.equal(i, imgs[0]) for i in imgs[1:]),
                "vs_single_max_abs": float((imgs[0] - single_img).abs().max()),
                "vs_single_mean_abs": float((imgs[0] - single_img).abs().mean()),
                "vs_single_psnr_db": -10 * math.log10(max(mse, 1e-30)),
                "tolerance": {"psnr_db": SERVE_PSNR_DB, "tiny_f32": TINY_SERVE_TOL},
                "tiny_rel_err_by_key": tiny_errs,
                "per_rank": recs})
            row["ok"] = bool(row["weights_equal"] and row["ranks_bit_equal"]
                             and row["vs_single_psnr_db"] >= SERVE_PSNR_DB
                             and all(e <= TINY_SERVE_TOL for e in tiny_errs.values())
                             and all(r["finite"] for r in recs))
        else:
            row["ok"] = False
        rows.append(row)
    lr = tiny.train.lr
    want_loss, want = tiny_train_ref
    chunks = 2 * cfg.latent_hw ** 2 * cfg.train.max_steps_train // 2 ** 17
    for name, n in (("tp_train", RANKS), ("fsdp_tp_train", FSDP_TP_RANKS)):
        rc, wall = launch_job(here, outdir, name, n, MODEL_TIMEOUT_S)
        recs = [read_json(os.path.join(outdir, f"{name}{r}.json")) for r in range(n)]
        row = {"phase": name, "ranks": n, "backend": "gloo", "launch_rc": rc,
               "launch_s": wall}
        got_path = os.path.join(outdir, f"tiny_{name}.pt")
        if rc == 0 and all(recs) and os.path.exists(got_path):
            got = torch.load(got_path, weights_only=False)
            loss_err = max(abs(recs[0]["tiny_loss"][k] - want_loss[k]) / abs(want_loss[k])
                           for k in want_loss)
            upd_err = compare_updates(got, want, before, lr)
            row.update({"mesh": recs[0]["mesh"], "tiny_loss_rel_err": loss_err,
                        "tiny_update_rel_err": upd_err,
                        "tolerance": {"loss": 1e-5, "update_l2": 1e-3},
                        "ranks_agree": all(r["tiny_loss"] == recs[0]["tiny_loss"]
                                           for r in recs),
                        "per_rank": [{k: v for k, v in r.items() if k != "losses"}
                                     for r in recs]})
            ok = (loss_err <= 1e-5 and upd_err <= 1e-3 and row["ranks_agree"]
                  and all(r["tiny_scatter_launches"] > 0 for r in recs))
            if name == "tp_train":
                dp = dp_row.get("per_rank") or [{}]
                row["dp_train_rank"] = {k: dp[0].get(k) for k in (
                    "resting_bytes", "max_memory_allocated", "param_bytes", "step_ms")}
                row["losses"] = recs[0]["losses"]
                ok = ok and all(r["scatter_launches"] == chunks * RANK_STEPS for r in recs) \
                    and all(math.isfinite(v) for r in recs for l in r["losses"]
                            for v in l.values())
            row["ok"] = bool(ok)
        else:
            row["ok"] = False
        rows.append(row)
    return rows


def run_sd_sharded(here, dev):
    """scripts/run_torch_sd.py's sharded denoise at full width on two ranks
    over gloo, tp 2 then sp 2 (``run_sd_job``), each held to the script's
    single-process denoise from the same start latents; then the script's
    own launch on this one card, ``--tp 2``, which must refuse."""
    import shutil

    import torch

    outdir = os.path.join(here, "chiprun_out", "run_sd_sharded")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    run_sd, cfg, params, latents, cond, sched = run_sd_inputs(dev)
    checksum = param_checksum(params)
    run_sd.denoise(params, latents, cond, cfg, sched, 1)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    single = run_sd.denoise(params, latents, cond, cfg, sched, SD_SHARDED_STEPS)
    torch.cuda.synchronize(dev)
    single_s = (time.perf_counter() - t) / SD_SHARDED_STEPS
    single = single.float().cpu()
    del params, latents, cond
    torch.cuda.empty_cache()
    rc, wall = launch_job(here, outdir, "run_sd", RANKS, MODEL_TIMEOUT_S)
    ranks = [read_json(os.path.join(outdir, f"run_sd{r}.json")) for r in range(RANKS)]
    row = {"phase": "run_sd_sharded", "ranks": RANKS, "backend": "gloo", "launch_rc": rc,
           "launch_s": wall, "image": 512, "latents": list(single.shape),
           "ddim_steps": SD_SHARDED_STEPS, "compute_dtype": "bfloat16",
           "single_process_s_per_step": single_s,
           "tolerance": {"psnr_db_over_peak": SD_SHARDED_PSNR_DB}, "cases": {}}
    ok = rc == 0 and all(ranks)
    for name, sp, tp in SD_SHARDED_CASES:
        paths = [os.path.join(outdir, f"run_sd_{name}_rank{r}.pt") for r in range(RANKS)]
        if not (ok and all(map(os.path.exists, paths))):
            ok = False
            continue
        got = [torch.load(p) for p in paths]
        err = got[0] - single
        psnr = 20 * math.log10(float(single.abs().max())
                               / max(float(err.pow(2).mean().sqrt()), 1e-30))
        case = {"sp": sp, "tp": tp, "per_rank": [r[name] for r in ranks],
                "ranks_bit_equal": all(torch.equal(x, got[0]) for x in got[1:]),
                "vs_single_max_abs": float(err.abs().max()),
                "vs_single_psnr_db_over_peak": psnr}
        case["ok"] = bool(case["ranks_bit_equal"] and psnr >= SD_SHARDED_PSNR_DB
                          and all(r[name]["finite"] for r in ranks))
        row["cases"][name] = case
        ok = ok and case["ok"]
    row["weights_equal"] = all(r.get("param_checksum") == checksum for r in ranks)
    refused = subprocess.run([sys.executable, os.path.join(here, "scripts", "run_torch_sd.py"),
                              "--tp", "2"], cwd=here, capture_output=True, text=True,
                             timeout=300)
    row["one_card_tp2"] = {"rc": refused.returncode,
                           "stderr_tail": refused.stderr.strip().splitlines()[-1:]}
    row["ok"] = bool(ok and row["weights_equal"] and refused.returncode != 0
                     and "needs 2 devices, have 1" in refused.stderr)
    return row


# each study script's rows at its defaults: the phase fails where one is missing
STUDY_ROWS = {"bench_torch_scatter_variants": 13, "bench_torch_step_ablation": 7,
              "bench_torch_eval_ablation": 6, "bench_torch_encode_split": 3,
              "bench_torch_table_dtype": 8, "bench_torch_gather_by_table": 7,
              "bench_torch_unet_layout": 16, "bench_torch_grid_refresh": 4}
SCATTER_VARIANT_TOL = 1e-5       # of max |index_add_|


def scripts_phase(here, dev, smi):
    """The eight study scripts in this process at their defaults (each
    ``run``), the scatter kernel's launch count set to 0 just before each
    and read just after; then the SDXL key manifests against the committed
    fixtures, byte for byte."""
    import shutil

    import torch

    from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level

    row = {"phase": "scripts", "nvidia_smi": smi, "rows": {}, "scatter_launches": {},
           "seconds_by_script": {}, "tolerance": {"scatter_rel_err": SCATTER_VARIANT_TOL}}
    ok = True
    for name in STUDY_ROWS:
        mod = load_script(name)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        hash_scatter_add_per_level.launches = 0
        if name == "bench_torch_scatter_variants":
            rows = mod.run(mod.build_parser().parse_args([]), dev)
        else:
            rows = mod.run(dev)
        row["scatter_launches"][name] = hash_scatter_add_per_level.launches
        row["seconds_by_script"][name] = time.perf_counter() - t
        row["rows"][name] = rows
        ok = ok and len(rows) == STUDY_ROWS[name] and all(
            isinstance(v, (int, float)) and math.isfinite(v) for v in rows.values())
    sv = row["rows"]["bench_torch_scatter_variants"]
    errs = {k: v for k, v in sv.items() if k.endswith("_max_rel_err")}
    row["scatter_kernel_rows_ok"] = len(errs) == 4 and all(
        v <= SCATTER_VARIANT_TOL for v in errs.values())
    out = os.path.join(here, ".cache", "chip_smoke_key_manifest")
    shutil.rmtree(out, ignore_errors=True)
    manifest = load_script("make_torch_sdxl_key_manifest")
    manifest.write(out)
    same = {}
    for name in manifest.NAMES:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(here, "tests", "fixtures", name), "rb") as b:
            same[name] = a.read() == b.read()
    shutil.rmtree(out, ignore_errors=True)
    row["key_manifests_equal_fixtures"] = same
    row["ok"] = bool(ok and row["scatter_kernel_rows_ok"] and all(same.values())
                     and row["scatter_launches"]["bench_torch_scatter_variants"] > 0
                     and row["scatter_launches"]["bench_torch_step_ablation"] > 0)
    return row


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
    ap.add_argument("--rank-worker", metavar="DIR",
                    help="run as one rank of the dp_train/fsdp_train phases (started by "
                         "this script with the three flags below), writing to DIR")
    ap.add_argument("--rank-job", default="dp_fsdp",
                    choices=["dp_fsdp"] + sorted(RANK_JOBS),
                    help="with --rank-worker: which phases' rank to run")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes")
    ap.add_argument("--process-id")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.rank_worker:
        if args.rank_job != "dp_fsdp":
            return model_job(args.rank_worker, sys.argv, args.rank_job)
        return rank_worker(args.rank_worker, sys.argv)
    if args.root:
        if not args.scatter_bench:
            ap.error("--root goes with --scatter-bench")
        here = os.path.dirname(os.path.abspath(__file__))
        root = os.path.realpath(args.root)
        if os.path.commonpath([root, os.path.realpath(here)]) != os.path.realpath(here):
            ap.error(f"--root must lie below {here}")
        sys.path.insert(0, root)
    from stable_nerf_tpu_torch.ops.hopper import build
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    disable_tf32()
    dev = resolve_device()
    smi = nvidia_smi()
    t = time.perf_counter()
    native = None
    if not args.scatter_bench:
        from stable_nerf_tpu_torch.data import native_loader

        native = os.path.basename(native_loader.build())    # g++ and zlib, or raise
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    reports = build.build(build.kernel_sources())
    build_s = time.perf_counter() - t
    for name, log in reports.items():
        print(f"ptxas report for csrc/{name}.cu:\n{log}", file=sys.stderr)
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "native_loader": native, "native_loader_build_s": native_s,
          "kernel_build_s": build_s, "kernels_built": sorted(reports),
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})

    cfg = flagship_config()
    if args.scatter_bench:
        return scatter_bench(dev, cfg, smi)
    t_start = time.perf_counter()
    t = time.perf_counter()
    setup = make_setup(cfg, dev, SEED)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t,
          "param_bytes": sum(x.numel() * x.element_size()
                             for x in tree_leaves(setup[0]))})

    t = time.perf_counter()
    x_main = main_path_positions(cfg, setup[4], dev,
                                 torch.Generator(device=dev).manual_seed(SEED + 5))
    cases, breakdowns = kernel_cases(dev, x_main)
    emit({"phase": "kernel_cases", "seconds": time.perf_counter() - t, "cases": cases,
          "e_per_level": breakdowns})
    del x_main
    t = time.perf_counter()
    floor = load_floor_script()
    gathers = gather_cases(dev, floor)
    emit({"phase": "gather_cases", "seconds": time.perf_counter() - t, "cases": gathers})
    phases = [with_seconds(encode_floor, dev, floor), with_seconds(parity_small, dev),
              with_seconds(serve_parity, dev)]
    for row in phases:
        emit(row)
    floor_row = phases[0]
    joint, state, opt = with_seconds(joint_full, dev, cfg, setup, JOINT_STEPS)
    emit(joint)
    phases += [joint, with_seconds(joint_budget, dev, cfg, setup, opt, BUDGET_STEPS)]
    emit(phases[-1])
    served, serve_state = with_seconds(serve, dev, cfg, setup)
    emit(served)
    phases.append(served)
    if args.profile:
        emit(with_seconds(profile_step, state, args.profile, "joint_step"))
        emit(with_seconds(profile_step, serve_state, args.profile, "serve_request"))
    del setup, state, serve_state, opt
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    looped = with_seconds(train_loop, dev, cfg, here)
    emit(looped)
    phases.append(looped)
    ckpt_dir = os.path.join(here, "chiprun_out", "sdxl_checkpoint")
    try:
        phases.append(with_seconds(pretrained, dev, cfg, ckpt_dir))
        emit(phases[-1])
        phases.append(with_seconds(cli, here, ckpt_dir))
        emit(phases[-1])
        cli_row = phases[-1]
        phases.append(with_seconds(sd_scripts, here, ckpt_dir))
        emit(phases[-1])
    finally:
        # ~6.9 GB: never left behind
        import shutil

        shutil.rmtree(ckpt_dir, ignore_errors=True)
    fitted, trained_case = with_seconds(fit_nerf, here, dev)
    emit(fitted)
    cases.append(trained_case)
    demoed = with_seconds(demo, here, dev)
    emit(demoed)
    phases += [fitted, demoed]
    profiled = with_seconds(profile_sd, here)
    emit(profiled)
    phases.append(profiled)
    # training across processes: remat, DP at world 1 on NCCL, two ranks on
    # the card over gloo (DP and FSDP), the CLI's parallel flags
    rematted = with_seconds(remat_phase, dev, cfg, joint)
    emit(rematted)
    dp1 = with_seconds(dp_world1, dev, cfg, joint)
    emit(dp1)
    dp_row, fsdp_row = with_seconds(two_ranks, here, dev, cfg, dp1)
    emit(dp_row)
    emit(fsdp_row)
    cli_dp_row = with_seconds(cli_dp, here)
    emit(cli_dp_row)
    phases += [rematted, dp1, dp_row, fsdp_row, cli_dp_row]
    # model-axis parallelism: TP and SP serving, TP training, FSDP x TP
    tp_serve_row, sp_serve_row, tp_row, fsdp_tp_row = with_seconds(
        model_axis, here, dev, cfg, served, dp_row)
    for row in (tp_serve_row, sp_serve_row, tp_row, fsdp_tp_row):
        emit(row)
    phases += [tp_serve_row, sp_serve_row, tp_row, fsdp_tp_row]
    # the scripts: run_torch_sd sharded, the study scripts, the key manifests
    sharded_sd = with_seconds(run_sd_sharded, here, dev)
    emit(sharded_sd)
    studied = with_seconds(scripts_phase, here, dev, smi)
    emit(studied)
    phases += [sharded_sd, studied]
    per_rank = lambda row: [r.get("scatter_launches") for r in row.get("per_rank", [])]  # noqa: E731
    emit({"phase": "run_time", "seconds": time.perf_counter() - t_start,
          "seconds_by_phase": {row["phase"]: row.get("seconds") for row in phases}})

    a, ga = cases[0], gathers[0]
    emit({"kernels": [{
        "name": "hash_scatter_add", "route": "cuda",
        "source": "stable_nerf_tpu_torch/csrc/hash_scatter.cu",
        "replaces": "stable_nerf_tpu/ops/pallas/scatter_v2.py:125",
        "also_replaces": "stable_nerf_tpu/ops/pallas/scatter.py:113",
        "launches": joint["scatter_launches"],
        "launches_by_path": {"joint_train": joint["scatter_launches"],
                             "train_loop": looped["scatter_launches"],
                             "cli_objaverse_pretrained":
                                 cli_row["objaverse"]["runs"]["train"].get("scatter_launches"),
                             "fit_nerf": fitted["scatter_launches"],
                             "demo": demoed["scatter_launches"],
                             "remat": rematted["scatter_launches"],
                             "dp_train_world1_nccl": dp1["scatter_launches"],
                             "dp_train_per_rank": per_rank(dp_row),
                             "fsdp_train_per_rank": per_rank(fsdp_row)
                             or fsdp_row.get("scatter_launches"),
                             "cli_dp": cli_dp_row["runs"]["train"].get("scatter_launches"),
                             "tp_train_per_rank": per_rank(tp_row),
                             "fsdp_tp_train_per_rank": [
                                 r.get("tiny_scatter_launches")
                                 for r in fsdp_tp_row.get("per_rank", [])],
                             "scatter_variants":
                                 studied["scatter_launches"]["bench_torch_scatter_variants"],
                             "step_ablation":
                                 studied["scatter_launches"]["bench_torch_step_ablation"]},
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
