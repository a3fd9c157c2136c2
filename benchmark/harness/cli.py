"""One run of one cell: build and warm up, measure for ``--seconds``,
optionally trace a short block, check the output against the plain
reference, and print the result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones (the spans of the window, then the
device trace of a block of ``traced_units`` after it).  A run exits 2
without a result when the card or the cards the cell asks for are missing,
and 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "stable_nerf_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``stable_nerf_tpu_torch`` is not ``stable_nerf_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(args, device, t_start: float, bench: Optional[Dict] = None,
        bench_dir: Optional[str] = None) -> Dict:
    """The result dict of one run on ``device`` (CPU in the tests)."""
    import torch

    from . import common, compare, spec, trace

    bench = bench if bench is not None else spec.benchmark()
    bench_dir = bench_dir or spec.BENCH
    cell = spec.cell(bench, args.workload)
    ctx = common.Context(cell=cell["name"], cfg=spec.config(cell["config"], bench_dir),
                         traffic=spec.traffic(cell["traffic"], bench_dir), seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace), device=device,
                         t_start=t_start)
    kind = spec.kind(ctx.traffic["kind"])
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    state = kind.setup(ctx)
    common.sync(device)
    setup_s = common.now() - t_start
    log(f"{ctx.cell}: set-up {setup_s:.3f} s")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = common.now()
    units = kind.run_units(state, ctx, seconds=ctx.seconds)
    common.sync(device)
    window_s = common.now() - t0
    failed = kind.failed(state)
    memory_peak = common.peak_bytes(device)
    log(f"{ctx.cell}: {units} {kind.UNIT} in {window_s:.3f} s, {failed} failed")
    each = state["spans"].get("request")
    if each:
        log(f"{ctx.cell}: request s " + " ".join(f"{x:.3f}" for x in each))

    traced = None
    if ctx.trace:
        path = os.path.join(ctx.out_dir, f"trace-{ctx.cell}.json")
        n = kind.trace_units(ctx)
        with trace.traced(path, lambda: common.sync(device)) as out:
            kind.run_units(state, ctx, count=n)
        traced = trace.summary(out["intervals"], out["window_s"])
        traced["units"] = n
        log(f"{ctx.cell}: traced {n} {kind.UNIT}: busy {traced['busy_s']:.3f} of "
            f"{traced['window_s']:.3f} s, {traced['launches']} device operations")

    forbidden = forbidden_modules()
    kept = kind.free(state)
    del state
    common.free(device)

    # the check: the plain reference on the same inputs, after the window
    t_check = common.now()
    numbers = kind.check(ctx, kept)
    correct, checks = compare.verdict(numbers, spec.limits(ctx.cell, bench_dir))
    common.free(device)
    log(f"{ctx.cell}: check {common.now() - t_check:.1f} s")

    run_rec = {"cell": ctx.cell, "cfg": ctx.cfg, "traffic": ctx.traffic, "unit": kind.UNIT,
               "setup_s": setup_s, "window_s": window_s, "units": units,
               "flops_per_unit": kind.flops_per_unit(ctx),
               "scatter_per_unit": kind.scatter_per_unit(ctx),
               "kind_name": (torch.cuda.get_device_name(device) if cuda else "cpu"),
               "spans": kept["spans"], "trace": traced}
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, ctx.cell, section):
        value = spec.metric_reader(m["name"], bench_dir)(run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_rec = {"platform": "gpu" if cuda else "cpu", "kind": run_rec["kind_name"],
               "count": 1, "memory_peak_bytes": memory_peak}
    if traced is not None:
        dev_rec.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    result = {"correct": bool(correct and failed == 0), "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev_rec}
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return {"result": result, "forbidden": forbidden, "checks": checks, "numbers": numbers,
            "run": run_rec}


def main(t_start: float, argv=None) -> int:
    args = parse(argv)
    import torch

    from . import spec

    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}")
        return 2
    torch.set_num_threads(4)          # the host's own work, beside the dispatch thread
    out = run(args, torch.device("cuda:0"), t_start, bench)
    forbidden = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if forbidden:
        log("loaded modules of JAX or the JAX package: " + ", ".join(forbidden))
        return 3
    for name, value, limit in out["checks"]:
        log(f"check {name} = {value!r} (limit {limit!r})")
    print(json.dumps(out["result"]), flush=True)
    return 0
