#!/usr/bin/env python
"""Full-SDXL joint-step batch sweep of the PyTorch/CUDA port (counterpart
of scripts/bench_batch_sweep.py): runs scripts/bench_torch_joint_full_sdxl.py
at each of ``--batches`` in a child process of its own and records ms a
step, views/s, the U-Net MFU floor and the allocator's peak a batch in
``BATCH_SWEEP_torch.json`` at the repository root.

Every batch runs without remat (U-Net remat is not ported: ROADMAP.md §1,
``parallel/``); a batch that does not fit the card is recorded as "OOM".
Rows merge into an existing record, keyed by batch, so that two runs
over different batches keep each other's rows.  The TPU's record,
``BATCH_SWEEP.json``, is never written: ``--out`` refuses that name.

Usage: python scripts/bench_torch_batch_sweep.py [--batches 1,2,4,8]
       [--timeout 2400] [--out BATCH_SWEEP_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from torch_study import BATCH_SWEEP, refuse_tpu_record  # noqa: E402


def run_one(batch: int, timeout: int) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "bench_torch_joint_full_sdxl.py"),
           "--batch", str(batch), "--iters", "3"]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"batch": batch, "remat": False, "error": f"timeout after {timeout}s"}
    if proc.returncode != 0:
        oom = "out of memory" in proc.stderr.lower()
        return {"batch": batch, "remat": False,
                "error": "OOM" if oom else f"rc={proc.returncode}",
                "stderr_tail": proc.stderr[-400:]}
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--out", default=os.path.join(ROOT, BATCH_SWEEP))
    args = ap.parse_args(argv)
    refuse_tpu_record(args.out)

    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = list(json.load(f).get("rows", []))

    def upsert(row):
        for i, r in enumerate(rows):
            if r.get("batch") == row.get("batch"):
                rows[i] = row
                return
        rows.append(row)

    for b in [int(x) for x in args.batches.split(",")]:
        print(f"sweep: batch={b}…", file=sys.stderr, flush=True)
        row = run_one(b, args.timeout)
        print(f"  -> {row}", file=sys.stderr, flush=True)
        upsert(row)
        with open(args.out, "w") as f:           # written after every batch
            json.dump({"workload": "full-SDXL joint train step (512^2/64^2, "
                                   "fwd+bwd+AdamW, frozen bf16, no remat)",
                       "rows": rows}, f, indent=1)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
