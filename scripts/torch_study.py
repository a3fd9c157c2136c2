"""Helpers shared by the PyTorch/CUDA port's study, sweep and SDXL scripts
(``scripts/bench_torch_*.py``, ``profile_torch_sd_denoise.py``,
``validate_torch_sdxl_checkpoint.py``), imported as a sibling module:
eager timing on the card, the card's name and peak, the study workloads'
intrinsics, the sweeps' record names, and the SDXL noise function for
``DDIMScheduler.denoise``.
"""

from __future__ import annotations

import os
import subprocess
import time

BATCH_SWEEP = "BATCH_SWEEP_torch.json"
HYBRID_SWEEP = "HYBRID_SWEEP_torch.json"
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


def refuse_tpu_record(path: str) -> None:
    """Raise SystemExit when ``path`` names one of the TPU's records
    (``BATCH_SWEEP.json``, ``HYBRID_SWEEP.json``): the port's sweeps write
    their own ``*_torch.json``."""
    if os.path.basename(path) in TPU_RECORDS:
        raise SystemExit(f"refusing to write {path}: {os.path.basename(path)} is the "
                         "JAX package's TPU record; the port writes *_torch.json")


def best_of_blocks(fn, n_blocks, n_iters, sync):
    """Steady-state seconds an iteration, the best of ``n_blocks`` blocks
    of ``n_iters`` calls ``fn(i)``, each block ending in ``sync()``."""
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


def detect_peak_flops():
    """(device name, dense bf16 peak FLOP/s, or None for an unknown card)."""
    import torch

    kind = torch.cuda.get_device_name(0)
    return kind, PEAK_BF16_FLOPS.get(kind)


def sdxl_eps(params, cfg, batch: int, device, pooled=None, compute_dtype=None):
    """The SDXL noise function of the checkpoint validator and the denoise
    profile, for ``DDIMScheduler.denoise``: ``unet_apply`` with zero IP
    tokens, the pooled embeds (zeros where None), the SDXL time ids at
    1024, compute in ``compute_dtype`` (bf16 where None).  Returns
    eps(x, t)."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.unet import unet_apply

    dtype = compute_dtype or torch.bfloat16
    ip_tokens = torch.zeros((batch, 4, cfg.cross_attention_dim), dtype=dtype, device=device)
    if pooled is None:
        pooled = torch.zeros((batch, cfg.pooled_projection_dim), device=device)
    time_ids = torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]],
                            device=device).expand(batch, 6)

    def eps(x, t):
        return unet_apply(params, x, t, ip_tokens, added_text_embeds=pooled,
                          added_time_ids=time_ids, cfg=cfg, compute_dtype=dtype)

    return eps
