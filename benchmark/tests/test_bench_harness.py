"""CPU tests of the port's benchmark at a tiny size; the card's test is
marked ``cuda`` and skips without one.

    python -m pytest benchmark/tests -q
    python -m pytest benchmark/tests -m cuda -q      # on the card
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import cli, compare, faults, flops, spec
from benchmark.tests import tinybench

BENCH = tinybench.BENCH
ROOT = os.path.dirname(BENCH)
REAL = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
FORBIDDEN = {"jax", "jaxlib", "flax", "stable_nerf_tpu"}


def _run(tmp_path, cell, *, seed=2 ** 31 + 11, trace=0):
    bench, d = tinybench.make(str(tmp_path))
    return cli.run(tinybench.args(cell, seed=seed, trace=trace), torch.device("cpu"),
                   cli_time(), bench, d)


def cli_time():
    import time

    return time.perf_counter()


# ------------------------------------------------------------ the contract

def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in REAL["configs"]] + [w["name"] for w in REAL["workloads"]]
    names += [m["name"] for s in ("end_to_end", "per_layer") for m in REAL[s]]
    names += [w[k] for w in REAL["workloads"] for k in ("config", "traffic")]
    names += [k for c in REAL["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), names
    assert len(set(names[:len(REAL["configs"]) + len(REAL["workloads"])])) == \
        len(REAL["configs"]) + len(REAL["workloads"])
    units = [m["unit"] for s in ("end_to_end", "per_layer") for m in REAL[s]]
    assert all(spec.UNIT.match(u) for u in units), units
    assert set(REAL) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in REAL["workloads"]:
        e2e = [m["name"] for m in spec.cell_metrics(REAL, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.cell_metrics(REAL, w["name"], "per_layer"), w["name"]


def test_every_per_layer_metric_moves_a_metric_of_each_of_its_cells():
    for m in REAL["per_layer"]:
        for cell in m["workloads"]:
            e2e = [x["name"] for x in spec.cell_metrics(REAL, cell, "end_to_end")]
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_name_has_its_files():
    for w in REAL["workloads"]:
        assert spec.config(w["config"])["name"] == w["config"]
        spec.kind(spec.traffic(w["traffic"])["kind"])
        assert spec.limits(w["name"])
    for s in ("end_to_end", "per_layer"):
        for m in REAL[s]:
            assert callable(spec.metric_reader(m["name"]))
    for c in REAL["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


# --------------------------------------------------------- found by name

def test_every_cell_has_a_tiny_twin():
    """A one-chip cell has its CPU twin in ``tests/tiny/cells/<cell>.json``,
    whose configuration and traffic are tiny files of their own."""
    for w in REAL["workloads"]:
        if w["chips"] != 1:
            continue
        path = tinybench.twin_path(w["name"])
        assert os.path.exists(path), f"{w['name']} has no tiny twin at {path}"
        twin = spec.load_json(path)
        assert spec.config(twin["config"], tinybench.TINY)
        assert spec.traffic(twin["traffic"], tinybench.TINY)
        assert set(twin["faults"]) <= set(faults.known(tinybench.kind(twin["tiny"]))), twin


def test_a_cell_without_a_tiny_twin_is_left_out_of_the_tiny_bench(tmp_path):
    real = json.loads(json.dumps(REAL))
    real["workloads"].append({"name": "sdxl_ngp.untwinned", "config": "sdxl_ngp",
                              "traffic": "train", "chips": 1, "why": "no tiny twin"})
    for m in real["end_to_end"] + real["per_layer"]:
        if m["name"] in ("train_step_ms", "train_mfu"):
            m["workloads"].append("sdxl_ngp.untwinned")
    bench, _ = tinybench.make(str(tmp_path), real)
    assert sorted(w["name"] for w in bench["workloads"]) == sorted(tinybench.CELLS)
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert set(m.get("workloads", [])) <= set(tinybench.CELLS), m
    assert spec.cell_metrics(bench, "tiny_joint.train", "end_to_end")[1]["name"] == "train_step_ms"


def test_a_new_cell_traffic_and_metric_are_found_by_their_files(tmp_path):
    bench, d = tinybench.make(str(tmp_path))
    with open(os.path.join(d, "traffic", "tiny_fit.json")) as f:
        t = json.load(f)
    t["rays"] = 128
    with open(os.path.join(d, "traffic", "tiny_fit_fewer.json"), "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(d, "configs", "tiny_ngp.json"),
                os.path.join(d, "configs", "tiny_ngp2.json"))
    shutil.copy(os.path.join(d, "limits", "tiny_ngp.fit.json"),
                os.path.join(d, "limits", "tiny_ngp2.fit_fewer.json"))
    with open(os.path.join(d, "metrics", "rays_a_step.fit.py"), "w") as f:
        f.write("def read(run):\n    return float(run['traffic']['rays'])\n")
    bench["workloads"].append({"name": "tiny_ngp2.fit_fewer", "config": "tiny_ngp2",
                               "traffic": "tiny_fit_fewer", "chips": 1})
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny_ngp2.fit_fewer"])
                           if m["name"] == "nerf_train_rays_per_s" else m
                           for m in bench["end_to_end"]]
    bench["per_layer"].append({"name": "rays_a_step.fit", "unit": "rays", "better": "higher",
                               "source": "program_counter", "layer": "NeRF fit step",
                               "moves": "nerf_train_rays_per_s",
                               "workloads": ["tiny_ngp2.fit_fewer"]})
    out = cli.run(tinybench.args("tiny_ngp2.fit_fewer", trace=1), torch.device("cpu"),
                  cli_time(), bench, d)
    assert out["result"]["metrics"]["rays_a_step.fit"]["value"] == 128.0
    assert out["result"]["attempted"] > 0


# ----------------------------------------------------------- the last line

@pytest.mark.parametrize("cell", sorted(tinybench.CELLS))
def test_a_run_is_correct_and_its_line_has_the_contract_keys(tmp_path, cell):
    out = _run(tmp_path, cell)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert not out["forbidden"]


def test_a_traced_run_adds_the_breakdown_and_its_window(tmp_path):
    out = _run(tmp_path, "tiny_ngp.fit", trace=1)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in res["device"] and "busy_s" in res["device"]
    assert "grid_refresh_ms.fit" in res["metrics"] and "fit_mfu" not in res["metrics"]


# -------------------------------------------------- what the card path loads

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        if os.sep + "tests" + os.sep in path:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "stable_nerf_tpu_torch" not in tops and not tops & FORBIDDEN, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.steps, benchmark.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    tops = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True).stdout
    assert "stable_nerf_tpu" not in tops and "jax" not in tops


def test_a_whole_run_loads_no_module_of_jax_or_the_jax_package(tmp_path):
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tinybench\n"
            "from benchmark.harness import cli\n"
            "bench, d = tinybench.make(%r)\n"
            "out = cli.run(tinybench.args('tiny_joint.train'), torch.device('cpu'), "
            "time.perf_counter(), bench, d)\n"
            "import stable_nerf_tpu_torch\n"
            "print(out['result']['correct'], cli.forbidden_modules())\n"
            % (ROOT, str(tmp_path)))
    line = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, cwd=str(tmp_path)).stdout.strip().splitlines()[-1]
    assert line == "True []"


def test_the_whole_name_is_compared():
    import stable_nerf_tpu_torch  # noqa: F401

    assert "stable_nerf_tpu_torch" in sys.modules
    assert not any(m.split(".")[0] == "stable_nerf_tpu_torch" for m in cli.forbidden_modules())


# ------------------------------------------------------- operations, bytes

def test_flops_and_bytes_at_a_tiny_shape_match_the_hand_count():
    u = {"block_out_channels": [4], "transformer_layers": [1], "layers_per_block": 1,
         "in_channels": 1, "out_channels": 1, "projection_class_embeddings_input_dim": 2,
         "cross_attention_dim": 3, "ip_num_tokens": 2}
    # time MLPs: 2(4·16 + 16·16 + 2·16 + 16·16) = 1216; conv_in 2·9·1·4·4 = 288;
    # down resnet 2·(2·9·4·4·4) + 2·16·4 = 2432; its transformer (s = 4,
    # c = 4, 2 text tokens of 4 minus 2 ip): proj 2·2·16·4 = 256, attn1
    # 4·128 + 4·64 = 768, attn2 2·(128) + 2·2·(2·3·4·2)/2... worked below
    s, c = 4, 4
    attn1 = 2 * c * c * s + 2 * 2 * c * c * s + 2 * c * c * s + 4 * s * s * c
    attn2 = (2 * c * c * s + 2 * 2 * 3 * c * 2 + 2 * c * c * s + 4 * s * 2 * c
             + 2 * 2 * 3 * c * 2 + 4 * s * 2 * c)
    ff = 2 * c * 8 * c * s + 2 * 4 * c * c * s
    tr = 2 * 2 * c * c * s + attn1 + attn2 + ff
    res = lambda cin, cout: 2 * 9 * cin * cout * s + 2 * 9 * cout * cout * s + 2 * 16 * cout \
        + (2 * cin * cout * s if cin != cout else 0)  # noqa: E731
    total = 1216 + 288 + res(4, 4) + tr + 2 * res(4, 4) + tr + 2 * (res(8, 4) + tr) \
        + 2 * 9 * 4 * 1 * s
    assert flops.unet_forward_flops(u, 1, 2) == total
    # K1: 10 samples, 2 levels, 8 corners, 2 features, 16 rows a level
    assert flops.scatter_bytes(10, 2, 8, 2, 16) == 10 * 2 * 8 * 4 + 10 * 2 * 8 * 2 * 4 + 2 * 16 * 2 * 4
    n = {"encoding_sigma": {"n_levels": 2, "n_features_per_level": 2}, "geo_feat_dim": 3,
         "network_sigma": {"n_neurons": 5, "n_hidden_layers": 1}, "encoding_dir": {"degree": 2},
         "channel_dim": 3, "network_color": {"n_neurons": 6, "n_hidden_layers": 2}}
    assert flops.nerf_sample_flops(n) == 2 * (4 * 5 + 5 * 4) + 2 * (7 * 6 + 6 * 6 + 6 * 3)
    v = {"block_out_channels": [2], "layers_per_block": 1, "latent_channels": 1, "in_channels": 3}
    # conv_in 2·9·3·2·16; resnet 2·(2·9·2·2·16); mid 2 resnets + 4·(2·2·2·16) + 4·16·16·2;
    # conv_out 2·9·2·2·16; quant 2·2·2·16
    assert flops.vae_encode_flops(v, 1, 4) == (1728 + 2304 + 2 * 2304 + 512 + 2048 + 1152 + 128)


# ------------------------------------------------------ the trace readers

@pytest.mark.parametrize("metric", ["hash_encode_ms.fit", "hash_encode_ms.fit_stochastic"])
def test_hash_encode_ms_reads_the_encode_kernels_of_the_trace(metric):
    read = spec.metric_reader(metric)
    kernels = [["void (anonymous namespace)::hash_encode_bwd_kernel<2, 8, float const>(...)",
                3.0, 32],
               ["void (anonymous namespace)::corner8_f2_kernel<false, false, int2>(...)", 9.0, 64],
               ["void (anonymous namespace)::hash_encode_fwd_kernel<2, float const>(...)", 2.0,
                40]]
    assert read({"trace": {"units": 4, "kernels": kernels}}) == pytest.approx(5.0 / 4)
    assert read({"trace": {"units": 4, "kernels": kernels[1:2]}}) is None
    assert read({"trace": None}) is None


# ------------------------------------------------- the check fails faults

@pytest.mark.parametrize("cell,fault", tinybench.FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    with faults.plant(fault, tinybench.kind(cell)):
        out = _run(tmp_path, cell)
    assert out["result"]["correct"] is False, out["numbers"]


def test_a_kind_plants_its_own_faults():
    """A kind that lists a fault in its ``FAULTS`` plants it with its own
    ``plant``; the faults it does not list are planted as before."""
    planted = []

    @contextlib.contextmanager
    def plant(name):
        planted.append(name)
        yield

    kind = types.SimpleNamespace(FAULTS=("zeroed",), plant=plant)
    assert faults.known(kind) == faults.FAULTS + ("zeroed",)
    step = torch.optim.Adam.step
    with faults.plant("zeroed", kind):
        assert planted == ["zeroed"] and torch.optim.Adam.step is step
    with faults.plant("unchanged", kind):
        assert planted == ["zeroed"] and torch.optim.Adam.step is not step
    assert torch.optim.Adam.step is step
    with pytest.raises(ValueError, match="zeroed"):
        with faults.plant("missing", kind):
            pass


@pytest.mark.parametrize("cell", sorted(tinybench.CELLS))
def test_the_control_reads_far_above_the_program(tmp_path, cell):
    """The reference one precision step down, in the program's place, reads
    at least three times what the program does at the tiny size, and the
    harness's own comparison with the cell's limits finds it not correct."""
    from benchmark.harness import common

    prog = _run(tmp_path, cell)["numbers"]
    bench, d = tinybench.make(str(tmp_path / "c"))
    w = spec.cell(bench, cell)
    ctx = common.Context(cell=cell, cfg=spec.config(w["config"], d),
                         traffic=spec.traffic(w["traffic"], d), seed=2 ** 31 + 11, seconds=0.5,
                         trace=False, device=torch.device("cpu"))
    ctl = faults.control_numbers(spec.kind(ctx.traffic["kind"]), ctx)
    assert max(ctl[k] / max(prog[k], 1e-12) for k in ctl) >= 3.0, (prog, ctl)
    assert compare.verdict(ctl, spec.limits(cell, d))[0] is False, ctl


# ----------------------------------------------------------------- the card

@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ngp_synthetic.fit",
                           "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
