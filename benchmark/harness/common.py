"""What every kind of cell shares: the run's context, the clock, the
norms leaf by leaf, and the program's trainable leaves by path."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from . import weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKED_STEPS = 3


@dataclasses.dataclass
class Context:
    """One run: the cell's configuration and traffic files (dicts), the
    seed, the window's length, whether it is traced, and the device."""
    cell: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    out_dir: str = os.path.join(ROOT, ".cache", "bench")
    t_start: float = 0.0


def mark(ctx: Context, what: str) -> None:
    """Log a part of the set-up as done, seconds from the process start."""
    sync(ctx.device)
    print(f"{ctx.cell}: {what} at {now() - ctx.t_start:.3f} s", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def norms(tensors: List[torch.Tensor]) -> List[float]:
    if not tensors:
        return []
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).tolist()


def paths_of(params: Dict, leaves: List[torch.Tensor]) -> List[tuple]:
    """The path in ``params`` of each tensor of ``leaves``, by identity."""
    by_id = {id(t): p for p, t in weights.leaves_with_path(params)}
    return [by_id[id(t)] for t in leaves]


def optimizer_leaves(opt) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def first_grad_norms(opt, leaves: List[torch.Tensor]) -> List[float]:
    """The first gradient as the optimizer got it, from Adam's state after
    its first update: exp_avg = (1 − β1)·g."""
    b1 = opt.param_groups[0]["betas"][0]
    # a leaf with no state got no update: its gradient reads as nothing
    moments = [opt.state.get(p, {}).get("exp_avg", torch.zeros(())) for p in leaves]
    return [n / (1.0 - b1) for n in norms(moments)]


def record(losses, grad_norms, start: List[torch.Tensor], leaves: List[torch.Tensor],
           paths: List[tuple]) -> Dict:
    """A ``checked_steps``-style record of the program, leaves ordered by
    path."""
    with torch.no_grad():
        change = norms([p.detach() - s for p, s in zip(leaves, start)])
    return by_path({"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                    "change_norms": change}, paths)


def by_path(rec: Dict, paths: List[tuple]) -> Dict:
    order = sorted(range(len(paths)), key=lambda i: paths[i])
    return {"losses": rec["losses"], "paths": [paths[i] for i in order],
            "grad_norms": [rec["grad_norms"][i] for i in order],
            "change_norms": [rec["change_norms"][i] for i in order]}


def training_check(reference_record, ctx: Context, kept: Dict) -> Dict[str, float]:
    """The training numbers: the program's checked steps against the
    reference's on the same inputs."""
    from . import compare

    ref = reference_record(ctx)
    if ref["paths"] != kept["checked"]["paths"]:
        raise RuntimeError("the program's trainable leaves are not the reference's")
    return compare.training_gaps(kept["checked"], ref)


def peak_bytes(device) -> Optional[int]:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def scatter_per_render(n: Dict, samples: int, stochastic: bool, chunk: int = 2 ** 17):
    """(K1 launches, K1 bytes) of a dense render's backward over
    ``samples``: one launch a chunk of ``chunk`` samples where they split
    evenly (``models/nerf/renderer.py``), else one."""
    from . import flops

    h = n["encoding_sigma"]
    m = [chunk] * (samples // chunk) if samples > chunk and samples % chunk == 0 else [samples]
    corners = 1 if stochastic else 8
    return len(m), sum(flops.scatter_bytes(x, h["n_levels"], corners, h["n_features_per_level"],
                                           1 << h["log2_hashmap_size"]) for x in m)
