"""A benchmark folder at the CPU test size: the tiny configurations and
traffic under ``tests/tiny/``, the real metric readers, and limits of their
own, with a ``BENCHMARK.json``-shaped dict naming the tiny cells.

Each real cell has its tiny twin, found by name in
``tests/tiny/cells/<real cell>.json``: the tiny cell's name (``tiny``), its
configuration and traffic under ``tests/tiny/configs`` and
``tests/tiny/traffic``, its ``limits`` (why in ``limits_why``) and the
planted ``faults`` of ``harness/faults.py`` it must fail.  A real cell
without a twin is left out of the tiny bench.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

from benchmark.harness import spec

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
TINY = os.path.join(HERE, "tiny")


def twin_path(real_cell: str) -> str:
    return os.path.join(TINY, "cells", real_cell + ".json")


# {real cell: its twin file}, for every twin file there is
TWINS = {f[:-len(".json")]: spec.load_json(os.path.join(TINY, "cells", f))
         for f in sorted(os.listdir(os.path.join(TINY, "cells"))) if f.endswith(".json")}
CELLS = {t["tiny"]: (t["config"], t["traffic"]) for t in TWINS.values()}
LIMITS = {t["tiny"]: t["limits"] for t in TWINS.values()}
FAULT_CASES = [(t["tiny"], fault) for t in TWINS.values() for fault in t["faults"]]


def kind(cell: str):
    """The kind module that drives the tiny cell ``cell``."""
    return spec.kind(spec.traffic(CELLS[cell][1], TINY)["kind"])


def make(tmp: str, real: Optional[Dict] = None):
    """(bench dict, bench dir) of the tiny cells under ``tmp``, their
    metrics those of ``real`` (the real ``BENCHMARK.json`` by default)."""
    d = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(TINY, sub), os.path.join(d, sub))
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(d, "metrics"))
    os.makedirs(os.path.join(d, "limits"))
    real = real if real is not None else spec.benchmark()
    bench = {"end_to_end": [], "per_layer": [], "workloads": []}
    for cell, (cfg, traffic) in CELLS.items():
        with open(os.path.join(d, "limits", cell + ".json"), "w") as f:
            json.dump({"limits": LIMITS[cell]}, f)
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": traffic, "chips": 1})
    real_to_tiny = {r: t["tiny"] for r, t in TWINS.items()}
    for section in ("end_to_end", "per_layer"):
        for m in real[section]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [real_to_tiny[w] for w in m["workloads"] if w in real_to_tiny]
            bench[section].append(m)
    return bench, d


def args(cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0):
    return argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
