"""Step timing and device memory (counterpart of
stable_nerf_tpu/utils/profiling.py).  Traces of the card are taken with
``torch.profiler`` by the training loop's ``profile_dir``."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


class StepTimer:
    """Step wall time and ray counts: an EMA of the time a step and totals.

    - ``with timer.step(rays=…):`` around a call that has finished when
      it returns (CUDA calls return early: synchronize inside);
    - ``timer.observe(steps, rays, seconds)`` with a span taken over a
      ``torch.cuda.synchronize()``, as the training loop reports each
      epoch's rate.
    """

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_dt: Optional[float] = None
        self.total_steps = 0
        self.total_rays = 0
        self.total_time = 0.0
        self._last_rays = 0

    @contextlib.contextmanager
    def step(self, rays: int = 0):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.total_steps += 1
        self.total_rays += rays
        self.total_time += dt
        self._last_rays = rays
        self.avg_dt = dt if self.avg_dt is None else (
            self.ema * self.avg_dt + (1 - self.ema) * dt)

    def observe(self, steps: int, rays: int, seconds: float):
        """Record a span of ``steps`` steps bounded by synchronizes."""
        if steps <= 0 or seconds <= 0:
            return
        self.total_steps += steps
        self.total_rays += rays
        self.total_time += seconds
        dt = seconds / steps
        self._last_rays = rays // steps
        self.avg_dt = dt if self.avg_dt is None else (
            self.ema * self.avg_dt + (1 - self.ema) * dt)

    def steps_per_sec(self) -> float:
        return 1.0 / self.avg_dt if self.avg_dt else 0.0

    def rays_per_sec(self) -> float:
        if not self.avg_dt or not self._last_rays:
            return 0.0
        return self._last_rays / self.avg_dt


def device_memory_stats() -> dict:
    """Memory of every CUDA device as the caching allocator counts it:
    bytes held by tensors now and at their peak, and the card's total
    ({} without a card)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
