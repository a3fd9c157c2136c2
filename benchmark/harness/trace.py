"""Reading the device's work out of a ``torch.profiler`` Chrome trace.

``chrome_trace_intervals`` and ``device_time`` are frozen copies of the
port's ``utils/profiling.py`` functions of the same names
(stable_nerf_tpu_torch, as of the benchmark's first version); ``summary``
adds the busy seconds inside the traced window and the breakdown of the
result line: the device operations that took most time, and the longest
idle gaps summed by the host operation that launched the work ending them.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

# Chrome-trace categories of work the device does
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def chrome_trace_intervals(path: str) -> List[Tuple[str, float, float, Optional[str]]]:
    """(name, start µs, end µs, launching op) of the kernels, copies and
    fills in a Chrome trace; the op is the ``cpu_op`` of the same
    "External id", None where there is none."""
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
    """The busy ms (the union of the intervals), the launch count, and
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
    table = sorted(([n, t / 1e3, c] for n, (t, c) in by_name.items()), key=lambda r: -r[1])
    return {"busy_ms": busy / 1e3, "launches": len(spans), "kernels": table}


def idle_gaps(intervals: List[Tuple]) -> List[Tuple[float, Optional[str]]]:
    """(µs, the op that launched the work ending the gap) of every gap
    between the union's busy stretches."""
    gaps, reach = [], None
    for name, start, end, op in sorted(intervals, key=lambda r: r[1]):
        if reach is not None and start > reach:
            gaps.append((start - reach, op or name))
        reach = end if reach is None else max(reach, end)
    return gaps


def summary(intervals: List[Tuple], window_s: float) -> Dict:
    """busy_s, the kernel table and the ``breakdown`` of a traced window."""
    dt = device_time(intervals)
    by_op: Dict[str, float] = {}
    for us, op in idle_gaps(intervals):
        by_op[op] = by_op.get(op, 0.0) + us / 1e6
    return {"busy_s": dt["busy_ms"] / 1e3, "window_s": window_s, "launches": dt["launches"],
            "kernels": dt["kernels"],
            "breakdown": {"device_ops": [[n, ms / 1e3] for n, ms, _ in dt["kernels"][:10]],
                          "idle_gaps": sorted(([k, v] for k, v in by_op.items()),
                                              key=lambda r: -r[1])[:10]}}


@contextlib.contextmanager
def traced(path: str, sync):
    """``torch.profiler`` over the block (host and CUDA activity), the
    block's wall seconds bounded by ``sync()``; yields a dict that holds
    ``window_s`` and ``intervals`` once the block has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: Dict = {}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    out["intervals"] = chrome_trace_intervals(path)
    os.remove(path)
