#!/usr/bin/env python
"""Sorted, streaming hash encode: the floor of its mandatory stages.

Counterpart of scripts/bench_fused_render_floor.py for the PyTorch/CUDA
port.  A fused render kernel that streams the hash table needs each
level's indices in sorted order, while the MLP consumes per-sample
features: 16 levels sort into 16 different permutations, so the sort and
the re-alignment are mandatory whatever else is fused.  This script
measures those stages against the production encode's table lookup on the
flagship ``HashGridConfig()`` (16 levels, T = 2^19, F = 2, 8 corners):

  A. the production lookup            weighted corner gather
                                      (ops/encoding.py::_encode_sections);
  B. per-level sort (index, rank)     ``torch.sort`` along each level's row;
  C. gather at the sorted indices     the hand-written row-gather kernel
                                      (ops/hopper/gather.py); the per-level
                                      sorted runs, concatenated, are
                                      globally sorted because level l's
                                      rows lie in [l·T, (l+1)·T);
  D. re-align to sample order         scatter-set by rank.

floor = B + C + D against A.  Stage D runs on stage C's output, and the
re-aligned rows must equal ``bf16(table)[flat_idx]`` exactly, so the path
checks itself.  Times are CUDA-event means after a warm-up on a card, and
host-clock means on the CPU (where stage C is the plain gather).

Usage: python scripts/bench_torch_fused_render_floor.py [--m-samples 262144]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from stable_nerf_tpu_torch.config import HashGridConfig  # noqa: E402
from stable_nerf_tpu_torch.ops.encoding import (_encode_sections,  # noqa: E402
                                                _indices_weights_exact)
from stable_nerf_tpu_torch.ops.hopper.gather import sorted_window_gather  # noqa: E402
from stable_nerf_tpu_torch.utils.device import resolve_device  # noqa: E402


def _mean_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def lookup(table, rows, cw):
    """Stage A: the production encode's weighted corner gather → [M, L·F]."""
    return _encode_sections(table, [(0, rows, cw)])


def sort_levels(idx_lm):
    """Stage B: [L, M·C] int32 → (sorted indices, rank of each in its row)."""
    return torch.sort(idx_lm, dim=1)


def realign(feats_sorted, srank):
    """Stage D: level-sorted rows [L, M·C, F] back to sample order."""
    index = srank.unsqueeze(-1).expand(-1, -1, feats_sorted.shape[-1])
    return torch.empty_like(feats_sorted).scatter_(1, index, feats_sorted)


def make_inputs(m_samples: int, device: torch.device, seed: int):
    """A random flagship table [L·T, F] and, for ``m_samples`` uniform
    positions, the encode's rows and weights [M, L, 8] (level offsets
    included) and the same rows per level, [L, M·8] int32."""
    cfg = HashGridConfig()
    L = cfg.n_levels
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((L * cfg.table_size, cfg.n_features_per_level), generator=g,
                        device=device)
    x = torch.rand((m_samples, 3), generator=g, device=device)
    rows, cw = _indices_weights_exact(x, cfg, 0, L)
    idx_lm = rows.permute(1, 0, 2).reshape(L, -1).to(torch.int32).contiguous()
    return table, rows, cw, idx_lm


def measure(m_samples: int = 2 ** 18, device=None, seed: int = 0, reps: int = 5) -> dict:
    """Run the four stages on ``device`` (default cuda) at ``m_samples``
    uniform positions and a random table made from ``seed``; returns the
    stage times and counts.  Raises if the re-aligned rows differ from
    ``bf16(table)[flat_idx]``."""
    dev = resolve_device(device)
    table, rows, cw, idx_lm = make_inputs(m_samples, dev, seed)
    M, L, C = rows.shape
    F = table.shape[1]

    launches = sorted_window_gather.launches
    sidx, srank = sort_levels(idx_lm)
    feats_sorted = sorted_window_gather(table, sidx.reshape(-1)).reshape(L, M * C, F)
    got = realign(feats_sorted, srank)
    want = table.to(torch.bfloat16).float()[idx_lm.long()]
    if not torch.equal(got, want):
        raise RuntimeError("sorted encode path: re-aligned rows differ from "
                           "bf16(table)[flat_idx]")
    del got, want

    a_ms = _mean_ms(lambda: lookup(table, rows, cw), dev, reps)
    b_ms = _mean_ms(lambda: sort_levels(idx_lm), dev, reps)
    c_ms = _mean_ms(lambda: sorted_window_gather(table, sidx.reshape(-1)), dev, reps)
    d_ms = _mean_ms(lambda: realign(feats_sorted, srank), dev, reps)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "m_samples": M, "levels": L, "corners": C, "items": M * L * C,
        "table_rows": table.shape[0], "features": F,
        "a_lookup_ms": a_ms, "b_sort_ms": b_ms, "c_gather_ms": c_ms,
        "d_realign_ms": d_ms, "floor_ms": b_ms + c_ms + d_ms,
        "realigned_equal": True,
        "gather_launches": sorted_window_gather.launches - launches,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m-samples", type=int, default=2 ** 18)
    args = ap.parse_args()
    r = measure(args.m_samples)
    print(f"device: {r['device']}")
    print(f"shape: M={r['m_samples']} samples, {r['levels']} levels, "
          f"{r['corners']} corners → {r['items'] / 1e6:.1f}M gathers, "
          f"table {r['table_rows']}×{r['features']}")
    print(f"A. production lookup (weighted gather):  {r['a_lookup_ms']:8.3f} ms")
    print(f"B. per-level sort (idx, rank):           {r['b_sort_ms']:8.3f} ms")
    print(f"C. gather at sorted indices (kernel):    {r['c_gather_ms']:8.3f} ms")
    print(f"D. re-align to sample order:             {r['d_realign_ms']:8.3f} ms")
    print(f"\nsorted encode floor (B+C+D):             {r['floor_ms']:8.3f} ms")
    print(f"vs production lookup (A):                {r['a_lookup_ms']:8.3f} ms")
    if r["floor_ms"] >= 0.9 * r["a_lookup_ms"]:
        print("verdict: NOT VIABLE: the mandatory stages alone cost "
              f"{r['floor_ms'] / r['a_lookup_ms']:.2f}x the production lookup.")
    else:
        print("verdict: VIABLE: the mandatory stages cost "
              f"{r['floor_ms'] / r['a_lookup_ms']:.2f}x the production lookup.")


if __name__ == "__main__":
    main()
