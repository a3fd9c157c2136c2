#!/usr/bin/env python
"""Hash-gradient scatter and gather variants on the card (counterpart of
scripts/bench_scatter_variants.py).

At the reference workload's shape (33,554,432 updates into a 16·2^19-row
table, F = 2; SURVEY §7's hard part) it races:

  * ``torch.sort`` alone, carrying the payload (what ``lax.sort`` with
    one key and the payload operands does);
  * ``index_add_``, the counterpart of XLA's ``.at[].add(mode="drop")``;
  * the CUDA scatter kernel (csrc/hash_scatter.cu through
    ``ops/hopper/scatter.py::hash_scatter_add_per_level``) on the sorted
    input.  The JAX package has two sorted-block Pallas kernels, v1
    (1024-entry blocks, ``scatter.py``) and v2 (4096-entry radix blocks,
    ``scatter_v2.py``); one CUDA kernel serves both roles, so the "v1" and
    "v2" rows time the same kernel.  The flat rows are one "level" of the
    wrapper's ``[M, L', C]`` layout (``[M, 1, 1]``, ``n_levels = 1``);
  * sort + kernel, for each row name;
  * the batched per-level sort ``[16, M/16]``, and the same with the two
    features rounded to bf16 and packed into one 32-bit word
    (``pack_bf16_pair``);
  * the flat gather ``table[idx]`` (the forward path's baseline).

Each kernel row prints its largest error against ``index_add_``,
relative to the largest magnitude of the result.  ``--check`` runs the
JAX script's small correctness case instead (40,000 updates into 8,192
rows).  Times are the best of 3 blocks ending in a synchronize
(``torch_study.best_ms``): the JAX script's ``lax.scan`` and host readout
exist for a remote TPU runtime, the card is timed eagerly.

Usage: python scripts/bench_torch_scatter_variants.py [--m 33554432]
       [--table 8388608] [--feat 2] [--check] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torch_study import best_ms, device_line  # noqa: E402
from stable_nerf_tpu_torch.ops.hopper.scatter import hash_scatter_add_per_level  # noqa: E402
from stable_nerf_tpu_torch.utils.device import disable_tf32, resolve_device  # noqa: E402

LEVELS = 16
CHECK_M, CHECK_T = 40000, 8192


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=2 ** 18 * 16 * 8)
    ap.add_argument("--table", type=int, default=2 ** 19 * 16)
    ap.add_argument("--feat", type=int, default=2)
    ap.add_argument("--check", action="store_true",
                    help="small-size correctness check against index_add_")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def pack_bf16_pair(upd: torch.Tensor) -> torch.Tensor:
    """[..., 2] f32 → [...] int32 holding the JAX package's uint32 word:
    each feature rounded to bf16, feature 0 in the high half."""
    b = upd.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return (b[..., 0] << 16) | b[..., 1]


def unpack_bf16_pair(packed: torch.Tensor) -> torch.Tensor:
    """[...] int32 → [..., 2] f32, the inverse of :func:`pack_bf16_pair`."""
    hi = ((packed >> 16) & 0xFFFF).to(torch.int16)
    lo = (packed & 0xFFFF).to(torch.int16)
    return torch.stack([hi, lo], dim=-1).view(torch.bfloat16).float()


def sort_pairs(idx: torch.Tensor, upd: torch.Tensor):
    """Sort by row, the payload carried along: (sorted rows, [M, F] rows)."""
    sidx, perm = torch.sort(idx)
    return sidx, upd[perm]


def sort_batched(idx: torch.Tensor, upd: torch.Tensor, levels: int = LEVELS):
    """``levels`` independent sorts of [levels, M/levels] rows."""
    i2 = idx.view(levels, -1)
    si, perm = torch.sort(i2, dim=1)
    u2 = upd.view(levels, i2.shape[1], -1)
    return si, torch.gather(u2, 1, perm[..., None].expand_as(u2))


def sort_batched_packed(idx: torch.Tensor, upd: torch.Tensor, levels: int = LEVELS):
    """The batched sort with the payload packed into one word a row
    (``pack_bf16_pair``), unpacked after."""
    i2 = idx.view(levels, -1)
    packed = pack_bf16_pair(upd.view(levels, i2.shape[1], 2))
    si, perm = torch.sort(i2, dim=1)
    return si, unpack_bf16_pair(torch.gather(packed, 1, perm))


def scatter_index_add(idx: torch.Tensor, upd: torch.Tensor, table: int) -> torch.Tensor:
    """``zeros([table, F]).index_add_(0, idx, upd)``: XLA's
    ``.at[idx].add(upd, mode="drop")`` for rows inside the table."""
    out = torch.zeros((table, upd.shape[1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx, upd)


def scatter_kernel(sidx: torch.Tensor, supd: torch.Tensor, table: int) -> torch.Tensor:
    """The scatter kernel on flat rows: one level of ``table`` rows."""
    M, F = supd.shape
    return hash_scatter_add_per_level(sidx.view(M, 1, 1), supd.reshape(M, 1, 1, F), 1, table)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out − ref| / max |ref| (the JAX script's measure)."""
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-30))


def inputs(m: int, table: int, feat: int, device, seed: int = 0):
    """Uniform rows in [0, table) and normal updates, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, table, (m,), generator=g, device=device, dtype=torch.int32)
    upd = torch.randn((m, feat), generator=g, device=device)
    return idx, upd


def check_case(idx: torch.Tensor, upd: torch.Tensor, table: int):
    """The ``--check`` case: {"ref": index_add_, "v1": kernel, "v2": kernel}
    on the sorted input."""
    ref = scatter_index_add(idx, upd, table)
    sidx, supd = sort_pairs(idx, upd)
    return {"ref": ref, "v1": scatter_kernel(sidx, supd, table),
            "v2": scatter_kernel(sidx, supd, table)}


def run(args, device) -> dict:
    """Every row: {name: ms} plus each kernel row's ``<name>_max_rel_err``."""
    M, T, F = args.m, args.table, args.feat
    idx, upd = inputs(M, T, F, device)
    rows = {}
    sidx, supd = sort_pairs(idx, upd)
    rows["sort"] = best_ms(lambda: sort_pairs(idx, upd), device, 3)
    ref = scatter_index_add(idx, upd, T)
    rows["index_add_"] = best_ms(lambda: scatter_index_add(idx, upd, T), device, 1)
    for name in ("v1 kernel", "v2 kernel"):
        rows[name] = best_ms(lambda: scatter_kernel(sidx, supd, T), device, 3)
        rows[name + "_max_rel_err"] = rel_err(scatter_kernel(sidx, supd, T), ref)
    for name in ("v1 sort+kernel", "v2 sort+kernel"):
        rows[name] = best_ms(lambda: scatter_kernel(*sort_pairs(idx, upd), T), device, 3)
        rows[name + "_max_rel_err"] = rel_err(scatter_kernel(*sort_pairs(idx, upd), T), ref)
    if M % LEVELS == 0:
        rows["sort batched"] = best_ms(lambda: sort_batched(idx, upd), device, 3)
        if F == 2:
            rows["sort batched, bf16-packed payload"] = best_ms(
                lambda: sort_batched_packed(idx, upd), device, 3)
    table = torch.randn((T, F), generator=torch.Generator(device=device).manual_seed(0),
                        device=device)
    rows["gather"] = best_ms(lambda: table[idx], device, 3)
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    disable_tf32()
    print(device_line(dev))
    if args.check:
        idx, upd = inputs(CHECK_M, CHECK_T, args.feat, dev)
        out = check_case(idx, upd, CHECK_T)
        for name in ("v1", "v2"):
            print(f"correctness {name} (the CUDA scatter kernel): max rel err "
                  f"{rel_err(out[name], out['ref']):.2e}")
        return 0
    rows = run(args, dev)
    M = args.m
    print(f"torch.sort {M / 1e6:.1f}M:             {rows['sort']:8.3f} ms")
    print(f"index_add_:                {rows['index_add_']:8.3f} ms")
    print("v1 and v2 are one CUDA kernel (csrc/hash_scatter.cu) in both roles")
    for name in ("v1 kernel", "v2 kernel", "v1 sort+kernel", "v2 sort+kernel"):
        print(f"{name:<26} {rows[name]:8.3f} ms   (max rel err "
              f"{rows[name + '_max_rel_err']:.2e})")
    if "sort batched" in rows:
        print(f"torch.sort batched [{LEVELS}, {M // LEVELS / 1e6:.1f}M]: "
              f"{rows['sort batched']:8.3f} ms")
    if "sort batched, bf16-packed payload" in rows:
        print(f"torch.sort batched, bf16-packed payload: "
              f"{rows['sort batched, bf16-packed payload']:6.3f} ms")
    print(f"gather {M / 1e6:.1f}M rows:         {rows['gather']:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
