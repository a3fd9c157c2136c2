#!/usr/bin/env python
"""A hash level's gather against its table size on the card (counterpart
of scripts/bench_gather_by_table.py).

Does a row gather get cheaper when its table is small enough to sit in
the card's 50 MB L2 cache?  If the time an item is flat in the table
size, a kernel holding the coarse levels on chip has headroom; if small
tables are already fast, it does not.  Measures ``table[idx]`` of
2^21 random rows from [T, 2] float32 tables for T = 2^12 … 2^19, then
the trilinear 8-corner form at the real encode's per-level load
(2^18 samples × 8 corners from a 2^19-row table).  The JAX script times
XLA's plain gather; so does this one (the sorted gather kernel,
csrc/sorted_gather.cu, serves the sorted-encode floor path instead).

Times are the best of 3 blocks of 20 calls ending in a synchronize
(``torch_study.best_ms``), the card timed eagerly.

Usage: python scripts/bench_torch_gather_by_table.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torch_study import best_ms, device_line  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402

LOG2_TABLES = (12, 14, 16, 17, 18, 19)
M_ROWS = 1 << 21
M_CORNER, T_CORNER = 1 << 18, 1 << 19


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def corner_gather(table, idx8, w8):
    """sum over 8 corners of table[idx8] · w8 → [M, F]."""
    return (table[idx8] * w8).sum(1)


def run(device, log2_tables=LOG2_TABLES, m: int = M_ROWS, m_corner: int = M_CORNER,
        t_corner: int = T_CORNER, n_iters: int = 20) -> dict:
    """{"T=2^k": ms} and {"8-corner": ms} at the given sizes (the JAX
    script's by default)."""
    g = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for k in log2_tables:
        table = torch.randn((1 << k, 2), generator=g, device=device)
        idx = torch.randint(0, 1 << k, (m,), generator=g, device=device)
        rows[f"T=2^{k}"] = best_ms(lambda: table[idx], device, n_iters)
    table = torch.randn((t_corner, 2), generator=g, device=device)
    idx8 = torch.randint(0, t_corner, (m_corner, 8), generator=g, device=device)
    w8 = torch.rand((m_corner, 8, 1), generator=g, device=device)
    rows["8-corner"] = best_ms(lambda: corner_gather(table, idx8, w8), device, n_iters)
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    disable_tf32()
    print(device_line(dev))
    rows = run(dev)
    print(f"M = {M_ROWS} row gathers; times in ms (ns an item in parens)")
    for k in LOG2_TABLES:
        ms = rows[f"T=2^{k}"]
        print(f"  T=2^{k:>2}: {ms:7.3f} ms  ({ms * 1e6 / M_ROWS:5.2f} ns/item)")
    ms = rows["8-corner"]
    print(f"  8-corner trilinear T=2^19, M={M_CORNER}: {ms:7.3f} ms "
          f"({ms * 1e6 / (M_CORNER * 8):5.2f} ns/corner)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
