#!/usr/bin/env python3
"""Readings that set the limits of the numbers deciding ``correct``, on the
card at a cell's own size: the control (the plain reference one precision
step down, in the program's place) and the planted faults.  The benchmark's
own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --what control
    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --what half_batch
    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --what program

``--what`` is ``control``, a fault of ``benchmark/harness/faults.py`` or of
the cell's kind (its ``FAULTS``), or
``program`` (a sound run with a short window: the lower readings of the
training cells, whose numbers come from set-up's checked steps); prints one
JSON line a seed: the seed, the cell's numbers and ``correct``, their
verdict against the cell's committed limits (``benchmark/limits/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark.harness import cli, common, compare, faults, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    bench = spec.benchmark()
    w = spec.cell(bench, args.workload)
    kind = spec.kind(spec.traffic(w["traffic"])["kind"])
    if args.what not in ("control", "program") + faults.known(kind):
        ap.error(f"--what {args.what!r}: not control, program or one of {faults.known(kind)}")
    import torch

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.what == "control":
            ctx = common.Context(cell=w["name"], cfg=spec.config(w["config"]),
                                 traffic=spec.traffic(w["traffic"]), seed=seed,
                                 seconds=args.seconds, trace=False, device=dev)
            numbers = faults.control_numbers(kind, ctx)
        else:
            run_args = argparse.Namespace(workload=w["name"], seed=seed, seconds=args.seconds,
                                          trace=0)
            sound = args.what == "program"
            with contextlib.nullcontext() if sound else faults.plant(args.what, kind):
                numbers = cli.run(run_args, dev, time.perf_counter(), bench)["numbers"]
        common.free(dev)
        correct, _ = compare.verdict(numbers, spec.limits(w["name"]))
        print(json.dumps({"cell": w["name"], "what": args.what, "seed": seed, "numbers": numbers,
                          "correct": correct, "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
