#!/usr/bin/env python
"""The occupancy-grid refresh at the production shape on the card
(counterpart of scripts/bench_grid_refresh.py).

``models/nerf/grid.py::update_extra_state`` (reference
nerf/renderer.py:236-327) sweeps every cell of the 128³ grid while
``iter_density`` < 16 (the full branch, renderer.py:252-276) and a quarter
of the cells plus as many draws among the occupied ones after (the
partial branch).  The branch is chosen as the JAX script chooses it:
``iter_density`` 0 for the full sweep, 20 for the partial one.  The
flagship NeRF (channel 4) gives the density, in chunks of ``--chunk``
points.  Times are the host clock around ``--iters`` refreshes ending in
a synchronize, after one refresh of each branch.

Usage: python scripts/bench_torch_grid_refresh.py [--grid 128]
       [--chunk 65536] [--iters 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torch_study import device_line  # noqa: E402
from stable_nerf_tpu_torch.config import NeRFConfig  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.grid import grid_init, update_extra_state  # noqa: E402
from stable_nerf_tpu_torch.models.nerf.network import nerf_density, nerf_init  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=2 ** 16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(device, grid: int = 128, chunk: int = 2 ** 16, iters: int = 3) -> dict:
    """{"first refresh s", "full ms", "partial ms", "occupied"} at the given
    grid side and chunk."""
    dev = torch.device(device)
    cfg = NeRFConfig(channel_dim=4, grid_size=grid)
    params = nerf_init(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def dens(x):
        return nerf_density(params, x, cfg)["sigma"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        state = update_extra_state(grid_init(cfg, device=dev), dens, cfg, generator=g,
                                   chunk=chunk)
        sync()
        rows["first refresh s"] = time.perf_counter() - t0
        rows["occupied"] = float(state.occ.float().mean())
        for label, it in (("full", 0), ("partial", 20)):
            st = state._replace(iter_density=torch.full_like(state.iter_density, it))
            update_extra_state(st, dens, cfg, generator=g, chunk=chunk)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                update_extra_state(st, dens, cfg, generator=g, chunk=chunk)
            sync()
            rows[f"{label} ms"] = (time.perf_counter() - t0) / iters * 1e3
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    disable_tf32()
    print(device_line(dev))
    rows = run(dev, args.grid, args.chunk, args.iters)
    print(f"first refresh (full sweep, its set-up included): {rows['first refresh s']:.2f} s")
    for label in ("full", "partial"):
        print(f"{label} sweep steady-state: {rows[label + ' ms']:.1f} ms "
              f"({args.grid}³ grid, chunk {args.chunk})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
