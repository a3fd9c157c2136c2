#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``stable_nerf_tpu_torch``): one
run of one cell of ``BENCHMARK.json``, from the root of a checkout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and the compared numbers with their limits on standard
error, and the result as one JSON line, the last of standard output.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "bench")
# every build and kernel cache stays in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[0] = ROOT                  # the checkout, not this script's folder

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
