#!/usr/bin/env python
"""Hybrid-encode frontier sweep of the PyTorch/CUDA port (counterpart of
scripts/bench_hybrid_sweep.py).

The hash encode has two endpoints, exact (8 corners) and stochastic (one
corner), and between them the hybrid encode
(``NeRFConfig.hash_stochastic_min_level``: exact below that level, one
corner above).  At the exact point, each of ``--levels`` and the
stochastic point this measures

  * speed: the full-SDXL joint train step
    (scripts/bench_torch_joint_full_sdxl.py, a child process): ms a step,
    rays/s;
  * quality: the synthetic-scene NeRF fit (scripts/fit_torch_nerf.py,
    ``--fit-steps`` steps): its FINAL mean PSNR.

and writes ``HYBRID_SWEEP_torch.json`` at the repository root.  Rows merge
into an existing record by mode, so the two legs can run apart
(``--skip-speed``, ``--skip-quality``).  The TPU's record,
``HYBRID_SWEEP.json``, is never written: ``--out`` refuses that name.  The
fits write under ``.cache/`` in the repository.

Usage: python scripts/bench_torch_hybrid_sweep.py [--levels 12,8,4]
       [--fit-steps 2000] [--skip-speed|--skip-quality]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from torch_study import HYBRID_SWEEP, refuse_tpu_record  # noqa: E402


def _name(min_level):
    """None = exact, 0 = fully stochastic, k = hybrid."""
    if min_level is None:
        return "exact"
    if min_level == 0:
        return "stochastic"
    return f"hybrid_min_level_{min_level}"


def _mode_flags(min_level):
    if min_level is None:
        return []
    return ["--stochastic", "--stochastic-min-level", str(min_level)]


def run_speed(min_level, timeout: int) -> dict:
    """One full-SDXL joint-step measurement."""
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "bench_torch_joint_full_sdxl.py"),
           "--iters", "3", *_mode_flags(min_level)]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"mode": _name(min_level), "error": f"timeout {timeout}s"}
    if proc.returncode != 0:
        return {"mode": _name(min_level), "error": f"rc={proc.returncode}",
                "stderr_tail": proc.stderr[-300:]}
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ms = out["joint_step_full_sdxl_ms"]
    return {"mode": _name(min_level), "joint_step_ms": ms,
            "rays_per_sec": round(8192 / ms * 1e3, 1),
            "first_step_s": out.get("first_step_s"),
            "wall_s": round(time.time() - t0, 1)}


def run_quality(min_level, steps: int, timeout: int) -> dict:
    """One synthetic-scene fit of ``steps`` steps → its mean PSNR."""
    out_dir = os.path.join(ROOT, ".cache", f"hybrid_fit_{_name(min_level)}")
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "fit_torch_nerf.py"),
           "--steps", str(steps), "--out", out_dir, "--log-every", str(steps),
           *_mode_flags(min_level)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"mode": _name(min_level), "error": f"timeout {timeout}s"}
    m = re.search(r"FINAL: mean PSNR over \d+ views = ([0-9.]+) dB", proc.stdout)
    if proc.returncode != 0 or not m:
        return {"mode": _name(min_level), "error": f"rc={proc.returncode}",
                "stderr_tail": proc.stderr[-300:]}
    return {"mode": _name(min_level), "fit_psnr_db": float(m.group(1)),
            "fit_steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--levels", default="12,8,4",
                    help="hybrid min_levels between the endpoints")
    ap.add_argument("--fit-steps", type=int, default=2000)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--skip-speed", action="store_true")
    ap.add_argument("--skip-quality", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, HYBRID_SWEEP))
    args = ap.parse_args(argv)
    refuse_tpu_record(args.out)

    points = [None] + [int(x) for x in args.levels.split(",") if x] + [0]
    rows = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f).get("rows", []):
                rows[r["mode"]] = r

    def flush():
        with open(args.out, "w") as f:
            json.dump({"workload_speed": "full-SDXL joint train step (8192 rays, "
                                         "budget 2^18, frozen bf16)",
                       "workload_quality": f"synthetic-scene fit_torch_nerf.py "
                                           f"{args.fit_steps} steps",
                       "rows": list(rows.values())}, f, indent=1)

    for lv in points:
        name = _name(lv)
        rows.setdefault(name, {"mode": name})
        if not args.skip_quality:
            print(f"quality: {name}…", file=sys.stderr, flush=True)
            rows[name].update(run_quality(lv, args.fit_steps, args.timeout))
            flush()
        if not args.skip_speed:
            print(f"speed: {name}…", file=sys.stderr, flush=True)
            rows[name].update(run_speed(lv, args.timeout))
            flush()
        print(f"  -> {rows[name]}", file=sys.stderr, flush=True)
    print(json.dumps(list(rows.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
