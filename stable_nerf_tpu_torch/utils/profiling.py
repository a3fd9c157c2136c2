"""Step timing, device memory and traces of the card (counterpart of
stable_nerf_tpu/utils/profiling.py).

``trace`` is ``torch.profiler`` over a block, written out as a Chrome
trace; ``chrome_trace_intervals`` reads the device's kernels, copies and
fills back from such a file, each with the host op that launched it, and
``device_time`` sums them by kernel name and takes the device's busy time
as the union of their intervals (kernels of several streams overlap).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# Chrome-trace categories of work the device does; "gpu_user_annotation"
# events are ranges named after host code, not work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """``torch.profiler`` over the block (host and CUDA activity); yields
    the profiler, and on exit writes ``<log_dir>/<name>.json``, a Chrome
    trace (chrome://tracing, Perfetto) that ``chrome_trace_intervals``
    reads back."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name + ".json"))


def live_array_bytes() -> int:
    """Bytes held by live tensors on the current CUDA device, as the
    caching allocator counts them."""
    return torch.cuda.memory_allocated()


def measured_hbm_gb() -> Tuple[str, float]:
    """(kind, GiB): the allocator's high-water mark on the current CUDA
    device, step temporaries included (``torch.cuda.max_memory_allocated``;
    reset it with ``torch.cuda.reset_peak_memory_stats``)."""
    return "allocator_peak", torch.cuda.max_memory_allocated() / 2 ** 30


def chrome_trace_intervals(path: str) -> List[Tuple[str, float, float, Optional[str]]]:
    """(name, start µs, end µs, launching op) of the kernels, copies and
    fills in a Chrome trace written by ``trace`` (``.json`` or
    ``.json.gz``); the op is the ``cpu_op`` event of the same "External
    id", None where there is none."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
              if e.get("ph") == "X"]
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             op_of.get(e.get("args", {}).get("External id")))
            for e in events if e.get("cat") in DEVICE_CATEGORIES]


def device_time(intervals: Iterable[Tuple]) -> Dict:
    """Device time of ``intervals`` (name, start µs, end µs, ...): the
    busy ms (the union of the intervals), the launch count, and
    ``[[name, ms, count], ...]`` summed by name, longest first."""
    by_name: Dict[str, Tuple[float, int]] = {}
    spans = []
    for name, start, end, *_ in intervals:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
        spans.append((start, end))
    busy, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    table = sorted(([n, t / 1e3, c] for n, (t, c) in by_name.items()),
                   key=lambda r: -r[1])
    return {"busy_ms": busy / 1e3, "launches": len(spans), "kernels": table}
