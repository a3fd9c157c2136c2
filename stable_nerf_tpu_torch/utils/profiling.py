"""Step timing, device memory, traces of the card, and the program's spans
and counters (counterpart of stable_nerf_tpu/utils/profiling.py).

``trace`` is ``torch.profiler`` over a block, written out as a Chrome
trace; ``chrome_trace_intervals`` reads the device's kernels, copies and
fills back from such a file, each with the host op that launched it, and
``device_time`` sums them by kernel name and takes the device's busy time
as the union of their intervals (kernels of several streams overlap).

``span(name)`` marks a stage of the program and ``count(name, n)`` adds to
a named counter.  Both are on while a ``torch.profiler`` session is active
(any: ``trace``, the training loop's ``--profile-dir``, a caller's own) or
inside ``tracing()``, and cost one flag check when off.  An open span is a
``record_function`` range in the profiler's trace, on the clock of the
kernels, and keeps its host ``perf_counter_ns`` interval and, on a card, a
pair of timing events on the current stream: ``span_records()`` gives both
as ``host_ms`` and ``device_ms``.  A span's device ms is stream time between
its two events, idle included: a stage whose host ms is about its device ms
is paced by the host's dispatch.
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# Chrome-trace categories of work the device does; "gpu_user_annotation"
# events are ranges named after host code, not work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StepTimer:
    """Step wall time and ray counts: an EMA of the time a step and totals,
    fed by ``timer.observe(steps, rays, seconds)`` with a span taken over a
    ``torch.cuda.synchronize()``, as the training loop reports each epoch's
    rate."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_dt: Optional[float] = None
        self.total_steps = 0
        self.total_rays = 0
        self.total_time = 0.0
        self._last_rays = 0

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


# ------------------------------------------------------- spans and counters

MAX_SPAN_RECORDS = 2 ** 20          # finished spans kept; later ones are counted as dropped

_profiler_enabled = torch._C._autograd._profiler_enabled
_forced = 0                         # open ``tracing()`` blocks


class _Tracer:
    """The finished spans, the spans open on any thread (in the order they
    opened) and the counters, behind one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.finished: List["_Span"] = []
        self.open: List["_Span"] = []
        self.counters: Dict = {}


_TRACER = _Tracer()


_OFF = contextlib.nullcontext()     # what ``span`` returns while spans are off


class _Span:
    """One open, then finished, span (see ``span``)."""

    __slots__ = ("name", "id", "parent", "unit", "thread", "t0", "t1", "range", "events",
                 "device_ms")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tracer = _TRACER
        thread = threading.get_ident()
        with tracer.lock:
            mine = [s for s in tracer.open if s.thread == thread]
            # none open here: autograd's worker thread runs a backward while
            # the thread that called backward() waits inside its own span
            parent = mine[-1] if mine else (tracer.open[-1] if tracer.open else None)
            self.id = next(tracer.ids)
            tracer.open.append(self)
        self.parent = parent.id if parent is not None else None
        self.unit = parent.unit if parent is not None else self.id
        self.thread = thread
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.events = None
        self.device_ms = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        tracer = _TRACER
        with tracer.lock:
            tracer.open.remove(self)
            if len(tracer.finished) < MAX_SPAN_RECORDS:
                tracer.finished.append(self)
            else:
                tracer.counters["spans.dropped"] = tracer.counters.get("spans.dropped", 0) + 1
        return False


def spans_enabled() -> bool:
    """Whether ``span`` and ``count`` record: a profiler session is active
    or a ``tracing()`` block is open."""
    return bool(_forced or _profiler_enabled())


def span(name: str):
    """``with span("joint.render"):`` marks a stage.

    Off (no profiler session, no ``tracing()``): one flag check, and a
    shared context that does nothing.  On: a ``record_function`` range where
    a profiler records; the host ``perf_counter_ns`` interval; on a card,
    two timing events on the current stream, resolved only by
    ``span_records`` (nothing here synchronizes); the parent, the innermost
    span open on this thread, else (on autograd's worker thread) the
    innermost open on another; and the unit, the id of the outermost span,
    shared by all its children."""
    if not (_forced or _profiler_enabled()):
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add ``n`` (a host int, or a 0-d device tensor, which accumulates on
    the device without a read) to the counter ``name``; nothing while
    spans are off."""
    if not (_forced or _profiler_enabled()):
        return
    tracer = _TRACER
    with tracer.lock:
        have = tracer.counters.get(name)
        if have is None:
            tracer.counters[name] = n.detach().clone() if torch.is_tensor(n) else n
        elif torch.is_tensor(have):
            have.add_(n)
        else:
            tracer.counters[name] = n + have


@contextlib.contextmanager
def tracing():
    """Spans and counters on inside the block, with no profiler: for an
    operator's own reading of ``span_records``, and to measure the spans'
    cost."""
    global _forced
    with _TRACER.lock:
        _forced += 1
    try:
        yield
    finally:
        with _TRACER.lock:
            _forced -= 1


def span_records() -> List[Dict]:
    """The finished spans in the order they closed: ``{name, id, parent,
    unit, thread, host_ms, device_ms}``; ``device_ms`` is the events'
    elapsed time, None off a card.  Reading waits for the events (once a
    span), never the spans themselves."""
    with _TRACER.lock:
        finished = list(_TRACER.finished)
    out = []
    for s in finished:
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "unit": s.unit,
                    "thread": s.thread, "host_ms": (s.t1 - s.t0) / 1e6,
                    "device_ms": s.device_ms})
    return out


def counters() -> Dict[str, int]:
    """The counters, device ones read to the host (one read each);
    ``spans.dropped`` counts spans past ``MAX_SPAN_RECORDS``."""
    with _TRACER.lock:
        items = list(_TRACER.counters.items())
    return {k: int(v) for k, v in items}


def reset_spans() -> None:
    """Forget the finished spans and the counters."""
    with _TRACER.lock:
        _TRACER.finished.clear()
        _TRACER.counters.clear()
