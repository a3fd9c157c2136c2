"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference works out.

Training (the joint step, the NeRF fit): the three checked steps' losses,
the first gradient as the optimizer got it, and the parameters' change
after the three, each taken leaf by leaf as the gap between the program's
norm and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger.  Leaves whose reference gradient is under
a thousandth of the median leaf's move by round-off alone under Adam and
are left out of the change.

Serving: the denoised images and the rendered latents of the sampled
requests, as the largest root-mean-square and absolute gaps.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

QUIET = 1e-3


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gap(prog: List[float], ref: List[float], keep=None) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, median ‖ref‖)."""
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} leaves against the reference's {len(ref)}")
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def training_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{loss_gap, grad_gap, change_gap} of two ``checked_steps`` records."""
    g_med = statistics.median(ref["grad_norms"])
    moving = [g >= QUIET * g_med for g in ref["grad_norms"]]
    return {"loss_gap": max(rel_gap(p, r) for p, r in zip(prog["losses"], ref["losses"])),
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], moving)}


def image_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
               prog_lt: List[torch.Tensor], ref_lt: List[torch.Tensor]) -> Dict[str, float]:
    img = max(float(((p.float() - r.float()) ** 2).mean().sqrt()) for p, r in zip(prog, ref))
    lt = max(float((p.float() - r.float()).abs().max()) for p, r in zip(prog_lt, ref_lt))
    return {"image_rmse": img, "render_gap": lt}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [[name, value, limit], ...]): every number at or under its
    limit, and none missing or not finite."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows
