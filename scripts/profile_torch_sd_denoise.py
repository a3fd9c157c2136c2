#!/usr/bin/env python
"""Where the time of the SDXL denoise step goes on the card: the
PyTorch/CUDA port's counterpart of scripts/profile_sd_denoise.py.

Runs the denoise workload (the full SDXL U-Net with IP heads from seed 0,
params in bf16, batch 2, 64² latents, a ``--steps`` DDIM loop through
``DDIMScheduler.denoise``) twice untraced for the step time, then once
more under ``torch.profiler`` (``utils/profiling.py::trace``), and sums
the device's time by bucket:

  conv              the launching op is a convolution, or the kernel's name
                    has conv / implicit_gemm / fprop / dgrad / wgrad
  attention-bmm     the launching op is aten::bmm / baddbmm / softmax or
                    scaled_dot_product_attention (the attention's products
                    are batched GEMMs, the linears' plain ones), or the
                    kernel's name has fmha / flash / softmax
  matmul            the launching op is aten::mm / addmm / linear / matmul,
                    or the kernel's name has gemm / cutlass / xmma / nvjet /
                    cublas
  copies            memcpy and memset, layout kernels (nchwToNhwc, transpose),
                    cat, and the kernels of aten::copy_ / to / _to_copy /
                    clone / contiguous / cat
  elementwise/norm  every other kernel of at::native (elementwise, norms,
                    reductions)
  other             the rest

The rules are tried in the order copies, conv, attention-bmm, matmul,
elementwise/norm; the first that matches wins.  Each kernel's launching op
is read from the Chrome trace the run writes (its "External id").  The
device's idle share is 1 − busy / wall, where busy is the union of the
kernels' intervals and wall the traced run's host clock
(``device_idle_share``) or the untraced step time
(``device_idle_share_of_timed_step``: tracing slows the host, not the
device).  ``step_ms_timed`` is the better of two untraced runs;
``mfu_analytic`` the analytic FLOPs a step (utils/flops.py) over it and
the card's dense bf16 peak (torch_study.PEAK_BF16_FLOPS).

Usage: python scripts/profile_torch_sd_denoise.py [--steps 10] [--outdir DIR]
       python scripts/profile_torch_sd_denoise.py --reanalyze DIR

``--outdir`` (default debug_out/profile_sd_denoise) receives the Chrome
trace ``sd_denoise.json`` and ``run.json`` (steps, batch, times, card);
``--reanalyze DIR`` buckets such a directory again without a card.  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

BUCKETS = ("conv", "attention-bmm", "matmul", "copies", "elementwise/norm", "other")
_COPY_OPS = {"aten::copy_", "aten::to", "aten::_to_copy", "aten::clone",
             "aten::contiguous", "aten::cat"}
_ATTN_OPS = {"aten::bmm", "aten::baddbmm", "aten::_softmax", "aten::softmax",
             "aten::scaled_dot_product_attention",
             "aten::_scaled_dot_product_efficient_attention",
             "aten::_scaled_dot_product_flash_attention"}
_MM_OPS = {"aten::mm", "aten::addmm", "aten::linear", "aten::matmul"}


def classify(name: str, op: Optional[str] = None) -> str:
    """The bucket of a device event: its kernel ``name`` and, where the
    profiler links one, the host ``op`` that launched it."""
    n = name.lower()
    op = op or ""
    if (op in _COPY_OPS or "memcpy" in n or "memset" in n or "nchwtonhwc" in n
            or "nhwctonchw" in n or "transpose" in n or "catarray" in n):
        return "copies"
    if "conv" in op or any(k in n for k in ("conv", "implicit_gemm", "fprop", "dgrad",
                                            "wgrad")):
        return "conv"
    if op in _ATTN_OPS or any(k in n for k in ("fmha", "flash", "softmax")):
        return "attention-bmm"
    if op in _MM_OPS or any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    if "at::native" in n or any(k in n for k in ("elementwise", "norm", "reduce")):
        return "elementwise/norm"
    return "other"


def build_sd_denoise(n_steps: int):
    """The denoise workload on the card: the full SDXL U-Net with IP heads
    from seed 0, params in bf16, zero pooled embeds, start latents
    [2, 4, 64, 64].  Returns denoise() → the latents after the
    ``n_steps`` loop."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config, unet_init
    from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device
    from stable_nerf_tpu_torch.utils.tree import tree_map
    from torch_study import sdxl_eps

    disable_tf32()
    dev = resolve_device()
    cfg = sdxl_unet_config()
    g = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                      unet_init(g, cfg, with_ip=True))
    latents0 = torch.randn((2, 4, 64, 64), generator=g, device=dev)
    scheduler = DDIMScheduler.create(device=dev)
    eps = sdxl_eps(params, cfg, 2, dev)
    return lambda: scheduler.denoise(eps, latents0, n_steps)


def analyze(intervals, steps: int, wall_ms: float, step_ms: float) -> dict:
    """Bucket ``intervals`` (utils/profiling.py's tuples) a step, with the
    busy time, the idle share of the traced ``wall_ms`` and of the
    untraced ``step_ms``, and the top kernels."""
    from stable_nerf_tpu_torch.utils.profiling import device_time

    intervals = list(intervals)
    dt = device_time(intervals)
    buckets = {b: 0.0 for b in BUCKETS}
    for name, start, end, op in intervals:
        buckets[classify(name, op)] += (end - start) / 1e3
    total = sum(buckets.values())
    return {
        "traced_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": dt["busy_ms"] / steps,
        "device_idle_share": 1.0 - dt["busy_ms"] / wall_ms,
        "device_idle_share_of_timed_step": 1.0 - dt["busy_ms"] / steps / step_ms,
        "launches_per_step": dt["launches"] / steps,
        "classified_ms_per_step": total / steps,
        "buckets_ms_per_step": {k: v / steps for k, v in buckets.items()},
        "buckets_pct": {k: 100.0 * v / total if total else 0.0 for k, v in buckets.items()},
        "top_kernels_ms_per_step": [[n[:100], ms / steps, c / steps]
                                    for n, ms, c in dt["kernels"][:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--outdir", default=os.path.join("debug_out", "profile_sd_denoise"))
    ap.add_argument("--reanalyze", metavar="DIR",
                    help="bucket the trace and run.json of an earlier run again")
    args = ap.parse_args(argv)

    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config
    from stable_nerf_tpu_torch.utils.flops import unet_forward_flops
    from stable_nerf_tpu_torch.utils.profiling import chrome_trace_intervals, trace

    if args.reanalyze:
        with open(os.path.join(args.reanalyze, "run.json")) as f:
            run = json.load(f)
        trace_dir = args.reanalyze
    else:
        import torch

        from torch_study import detect_peak_flops

        denoise = build_sd_denoise(args.steps)
        denoise()                                   # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            denoise()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / args.steps)
        step_ms = min(times)
        with trace(args.outdir, "sd_denoise"):
            t0 = time.perf_counter()
            denoise()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kind, peak = detect_peak_flops()
        run = {"steps": args.steps, "batch": 2, "step_ms_timed": step_ms,
               "traced_wall_ms": wall_ms, "device_kind": kind, "peak_bf16_flops": peak}
        with open(os.path.join(args.outdir, "run.json"), "w") as f:
            json.dump(run, f)
        trace_dir = args.outdir

    intervals = chrome_trace_intervals(os.path.join(trace_dir, "sd_denoise.json"))
    flops_step = unet_forward_flops(sdxl_unet_config(), run["batch"], 64)
    peak = run["peak_bf16_flops"]
    result = {
        "workload": f"SDXL U-Net denoise, batch {run['batch']}, 64^2 latents, bf16, "
                    f"{run['steps']}-step DDIM loop",
        "device_kind": run["device_kind"],
        "step_ms_timed": run["step_ms_timed"],
        **analyze(intervals, run["steps"], run["traced_wall_ms"], run["step_ms_timed"]),
        "analytic_tflop_per_step": flops_step / 1e12,
        "mfu_analytic": (flops_step / (run["step_ms_timed"] / 1e3) / peak
                         if peak else None),
        "trace_dir": trace_dir,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
