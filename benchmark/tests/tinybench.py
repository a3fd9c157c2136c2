"""A benchmark folder at the CPU test size: the tiny configurations and
traffic under ``tests/tiny/``, the real metric readers, and limits of their own,
with a ``BENCHMARK.json``-shaped dict naming its four cells."""

from __future__ import annotations

import argparse
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CELLS = {"tiny_joint.train": ("tiny_joint", "tiny_train"),
         "tiny_joint.serve": ("tiny_joint", "tiny_serve"),
         "tiny_ngp.fit": ("tiny_ngp", "tiny_fit"),
         "tiny_ngp.fit_stochastic": ("tiny_ngp", "tiny_fit_stochastic")}
# Set as a cell's own are, from readings at this size (the program on 11
# seeds, the control on 6): each cell's separating number lies above the
# program's highest and below the control's lowest -- the joint step's
# grad_gap (program under 1.7e-2, control over 0.1), the fits' grad_gap
# (under 2.7e-3, over 9.4e-3), the request's image_rmse (under 4.7e-4,
# over 4.2e-3); the others are loose.
LIMITS = {"tiny_joint.train": {"loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.05},
          "tiny_joint.serve": {"image_rmse": 1.5e-3, "render_gap": 1e-2},
          "tiny_ngp.fit": {"loss_gap": 0.05, "grad_gap": 5e-3, "change_gap": 0.05},
          "tiny_ngp.fit_stochastic": {"loss_gap": 0.05, "grad_gap": 5e-3, "change_gap": 0.05}}


def make(tmp: str):
    """(bench dict, bench dir) of the tiny cells under ``tmp``."""
    d = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(HERE, "tiny", sub), os.path.join(d, sub))
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(d, "metrics"))
    os.makedirs(os.path.join(d, "limits"))
    real = json.load(open(os.path.join(BENCH, "..", "BENCHMARK.json")))
    bench = {"end_to_end": [], "per_layer": [], "workloads": []}
    for cell, (cfg, traffic) in CELLS.items():
        with open(os.path.join(d, "limits", cell + ".json"), "w") as f:
            json.dump({"limits": LIMITS[cell]}, f)
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": traffic, "chips": 1})
    real_to_tiny = {"sdxl_ngp.train": "tiny_joint.train", "sdxl_ngp.serve": "tiny_joint.serve",
                    "ngp_synthetic.fit": "tiny_ngp.fit",
                    "ngp_synthetic.fit_stochastic": "tiny_ngp.fit_stochastic"}
    for section in ("end_to_end", "per_layer"):
        for m in real[section]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [real_to_tiny[w] for w in m["workloads"]]
            bench[section].append(m)
    return bench, d


def args(cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0):
    return argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
