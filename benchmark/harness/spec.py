"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the general
driver in ``benchmark/harness/kinds/``) and ``benchmark/limits/<cell>.json``
(the limits of the numbers that decide ``correct``); a per-layer metric
``<name>`` is read by ``benchmark/metrics/<name>.py``'s ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: str = BENCH) -> Dict:
    return load_json(os.path.join(bench_dir, "configs", name + ".json"))


def traffic(name: str, bench_dir: str = BENCH) -> Dict:
    return load_json(os.path.join(bench_dir, "traffic", name + ".json"))


def limits(cell_name: str, bench_dir: str = BENCH) -> Dict[str, float]:
    return load_json(os.path.join(bench_dir, "limits", cell_name + ".json"))["limits"]


def kind(name: str):
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad kind {name!r}")
    return importlib.import_module(f"benchmark.harness.kinds.{name}")


def metric_reader(name: str, bench_dir: str = BENCH):
    """``read`` of ``metrics/<name>.py``, loaded from its file (a metric's
    name may hold dots)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell_name: str, section: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it; an end-to-end metric that lists no
    cells is every cell's, a per-layer one every cell's that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if section == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in moved else [])]
