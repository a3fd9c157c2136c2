"""bench_torch.py and its scripts on the CPU: what can be held without a
card.

* The synthetic scene's analytic occupancy equals bench.py's boolean grid,
  and the occupancy-driven eval budget equals the JAX package's.
* The keys bench_torch.py can emit are bench.py's ``result[...]`` keys,
  read from both sources, plus ``sd_denoise_gflops_per_step_counted``.
* Without a card ``main()`` prints one ``"error"`` record and exits
  non-zero; with the bench functions stubbed, a budget of 0 skips and
  records every metric, a failing metric records its error, and the
  merges read the port's ``*_torch.json`` and demo workdir, never the TPU's
  records.
* The sweeps refuse to write the TPU's records; the full-SDXL bench's
  ``--remat`` builds the remat U-Net and counts its FLOPs × 4/3, as
  bench_joint_full_sdxl.py does; the denoise profile's buckets and its
  ``--reanalyze`` of a saved trace; the profiling helpers' busy time.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import bench_torch
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.training.joint import eval_budget_for_occupancy as jax_budget
from stable_nerf_tpu_torch.config import NeRFConfig, TrainConfig
from stable_nerf_tpu_torch.training.joint import eval_budget_for_occupancy
from stable_nerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grid_size", [32, 128])
def test_scene_occupancy_grid_equals_bench_py(grid_size):
    got = bench_torch._scene_occupancy_grid(NeRFConfig(channel_dim=4, grid_size=grid_size))
    want = jbench._scene_occupancy_grid(JNeRFConfig(channel_dim=4, grid_size=grid_size))
    assert got.dtype == want.dtype == bool and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("occ", ["scene", 0.0, 0.003, 0.05, 0.5, 1.0, None])
def test_auto_eval_budget_equals_jax(occ):
    if occ == "scene":
        occ = float(bench_torch._scene_occupancy_grid(NeRFConfig(channel_dim=4)).mean())
    assert eval_budget_for_occupancy(occ, 4096, TrainConfig()) == jax_budget(
        occ, 4096, JTrainConfig())


def _result_keys(path):
    """The keys a bench script stores in ``result``: literal keys and
    f-string templates (``{name}_skipped``), and the initial dict's."""
    with open(path) as f:
        src = f.read()
    keys = set(re.findall(r'result\[f?"([^"]+)"\]', src))
    init = re.search(r"result = \{(.*?)\n    \}", src, re.S).group(1)
    return keys | set(re.findall(r'"(\w+)":', init))


def test_emitted_keys_are_bench_py_keys():
    port = _result_keys(os.path.join(REPO, "bench_torch.py"))
    jax = _result_keys(os.path.join(REPO, "bench.py"))
    assert {"metric", "value", "unit", "vs_baseline", "sd_denoise_mfu",
            "joint_step_full_sdxl_ms", "{name}_skipped", "{name}_error"} <= port
    assert port - jax == {"sd_denoise_gflops_per_step_counted"}


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_main_without_a_card_prints_an_error_record_and_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert "error" in rec and rec["value"] == 0.0 and rec["vs_baseline"] is None


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """bench_torch with every bench function stubbed, a card pretended, and
    the repository root moved to tmp_path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(bench_torch, "HERE", str(tmp_path))
    monkeypatch.setattr(bench_torch, "bench_nerf_render",
                        lambda stochastic=False: (2e5 if stochastic else 1e5, 0.08, 2))
    monkeypatch.setattr(bench_torch, "bench_nerf_eval",
                        lambda: (12.0, 6.0, 0.0132, 65536))
    monkeypatch.setattr(bench_torch, "bench_sd_denoise",
                        lambda n_steps=10, batch=2: (10.0, 100.0, 0.03, "card", 989.4e12,
                                                     3.06e12, 3.05e12,
                                                     ("allocator_peak", 6.0 * batch)))
    monkeypatch.setattr(bench_torch, "bench_joint_step", lambda stochastic=False: 80.0)
    monkeypatch.setattr(bench_torch, "bench_joint_full_sdxl",
                        lambda timeout_s=2400: {"joint_step_full_sdxl_ms": 500.0,
                                                "hbm_gb": 17.0})
    return tmp_path


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_main_with_stubs_emits_bench_py_keys_cumulatively(stubbed, capsys, monkeypatch):
    monkeypatch.delenv("BENCH_BUDGET_S", raising=False)
    assert bench_torch.main() == 0
    recs = _records(capsys)
    for a, b in zip(recs, recs[1:]):             # each line extends the last
        assert set(a) <= set(b)
    last = recs[-1]
    assert last["value"] == 1e5 and last["vs_baseline"] is None
    assert last["sd_denoise_mfu"] == 0.03 and last["sd_denoise_ms_per_step_b8"] == 100.0
    assert last["sd_denoise_gflops_per_step_counted"] == 3050.0
    assert last["joint_step_full_sdxl_ms"] == 500.0 and last["joint_step_ms"] == 80.0
    jax = _result_keys(os.path.join(REPO, "bench.py"))
    pattern = re.compile("^(" + "|".join(re.sub(r"\\\{\w+\\\}", r"\\w+", re.escape(k))
                                         for k in jax) + ")$")
    extra = [k for k in last if not pattern.match(k)]
    assert extra == ["sd_denoise_gflops_per_step_counted"]


def test_zero_budget_skips_and_records_every_metric(stubbed, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    assert bench_torch.main() == 0
    last = _records(capsys)[-1]
    assert last["value"] == 1e5                  # the headline always runs
    for name in ("nerf_stochastic", "batch_sweep_record", "joint_full_sdxl", "nerf_eval",
                 "sd_denoise", "joint_step", "joint_step_stochastic", "sd_denoise_b4",
                 "sd_denoise_b8"):
        assert "insufficient budget" in last[f"{name}_skipped"]
    assert "sd_denoise_ms_per_step" not in last


def test_a_failing_metric_records_its_error_and_the_run_goes_on(stubbed, capsys,
                                                                monkeypatch):
    def broken():
        raise RuntimeError("eval broke")

    monkeypatch.setattr(bench_torch, "bench_nerf_eval", broken)
    assert bench_torch.main() == 0
    last = _records(capsys)[-1]
    assert last["nerf_eval_error"] == "eval broke"
    assert last["sd_denoise_ms_per_step"] == 100.0


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_merges_read_the_ports_records_never_the_tpus(stubbed, capsys):
    root = str(stubbed)
    tpu_demo = json.dumps({"inference": True, "inference_psnr": 18.49, "epoch": 199})
    _write(os.path.join(root, "BATCH_SWEEP.json"), {"rows": [{"batch": 1, "tpu": True}]})
    _write(os.path.join(root, "HYBRID_SWEEP.json"),
           {"rows": [{"mode": "hybrid_min_level_8", "joint_step_ms": 1.0}]})
    _write(os.path.join(root, "runs", "demo_diffusion", "metrics.jsonl"), tpu_demo + "\n")
    _write(os.path.join(root, "BENCH_baseline.json"), {"value": 1.0})
    assert bench_torch.main() == 0
    last = _records(capsys)[-1]
    for key in ("joint_batch_sweep", "joint_hybrid_sweep", "joint_step_ms_hybrid",
                "learned_demo_denoised_psnr_db"):
        assert key not in last
    assert last["vs_baseline"] is None

    port_demo = [json.dumps({"inference": True, "inference_psnr": 17.391, "epoch": 99}),
                 json.dumps({"train_loss": 0.1}),
                 json.dumps({"inference": True, "inference_psnr": 19.0912, "epoch": 199})]
    _write(os.path.join(root, "BATCH_SWEEP_torch.json"), {"rows": [{"batch": 1}]})
    _write(os.path.join(root, "HYBRID_SWEEP_torch.json"),
           {"rows": [{"mode": "exact", "joint_step_ms": 600.0},
                     {"mode": "hybrid_min_level_8", "joint_step_ms": 450.0}]})
    _write(os.path.join(root, "output_port_demo", "metrics.jsonl"), "\n".join(port_demo))
    _write(os.path.join(root, "BENCH_torch_baseline.json"), {"value": 5e4})
    assert bench_torch.main() == 0
    last = _records(capsys)[-1]
    assert last["joint_batch_sweep"] == {"rows": [{"batch": 1}]}
    assert last["joint_step_ms_hybrid"] == 450.0
    assert last["learned_demo_denoised_psnr_db"] == 19.09 and last["learned_demo_epoch"] == 199
    assert last["vs_baseline"] == 2.0


@pytest.mark.parametrize("script,record", [("bench_torch_batch_sweep", "BATCH_SWEEP.json"),
                                           ("bench_torch_batch_sweep", "HYBRID_SWEEP.json"),
                                           ("bench_torch_hybrid_sweep", "HYBRID_SWEEP.json"),
                                           ("bench_torch_hybrid_sweep", "BATCH_SWEEP.json")])
def test_sweeps_refuse_the_tpu_records(script, record, tmp_path, monkeypatch):
    mod = _script(script)

    def no_run(*a, **kw):
        raise AssertionError("the sweep ran a child before refusing")

    monkeypatch.setattr(subprocess, "run", no_run)
    out = tmp_path / record
    with pytest.raises(SystemExit, match="TPU record"):
        mod.main(["--out", str(out)])
    assert not out.exists()


def test_sweep_defaults_are_the_ports_records():
    for script, name in (("bench_torch_batch_sweep", "BATCH_SWEEP_torch.json"),
                         ("bench_torch_hybrid_sweep", "HYBRID_SWEEP_torch.json")):
        src = open(os.path.join(SCRIPTS, script + ".py")).read()
        assert "default=os.path.join(ROOT, " in src
        assert getattr(bench_torch, "BATCH_SWEEP" if "batch" in script else "HYBRID_SWEEP") \
            == name


def test_batch_sweep_merges_rows_by_batch(tmp_path, monkeypatch):
    mod = _script("bench_torch_batch_sweep")
    out = tmp_path / "BATCH_SWEEP_torch.json"
    out.write_text(json.dumps({"rows": [{"batch": 1, "old": True}, {"batch": 8, "old": True}]}))
    monkeypatch.setattr(mod, "run_one", lambda b, timeout: {"batch": b, "new": True})
    assert mod.main(["--batches", "1,2", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert rows == [{"batch": 1, "new": True}, {"batch": 8, "old": True},
                    {"batch": 2, "new": True}]


@pytest.mark.parametrize("batch", [1, 4])
def test_full_sdxl_bench_remat_config_and_flops(batch):
    """--remat reaches the step's U-Net configuration, and the U-Net FLOPs
    of a step grow by 4/3 (the recomputed forward), as the JAX script's
    ``unet_flops *= 4/3``; the plain count is 3 × the analytic forward."""
    from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config
    from stable_nerf_tpu_torch.utils.flops import unet_forward_flops

    mod = _script("bench_torch_joint_full_sdxl")
    assert mod.build_parser().parse_args(["--remat"]).remat
    assert mod.joint_config(batch=batch, remat=True).sd.unet.remat
    assert not mod.joint_config(batch=batch).sd.unet.remat
    plain = mod.unet_step_flops(batch, remat=False)
    assert plain == 3.0 * unet_forward_flops(sdxl_unet_config(), 2 * batch, 64)
    assert mod.unet_step_flops(batch, remat=True) == pytest.approx(plain * 4 / 3,
                                                                    rel=1e-15)


@pytest.mark.parametrize("name,op,bucket", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", None, "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", None, "copies"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", "aten::mm", "matmul"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", "aten::bmm", "attention-bmm"),
    ("void cunn_SoftMaxForward<4, float, float, float>", None, "attention-bmm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>",
     "aten::add", "elementwise/norm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::bfloat16_copy_kernel>",
     "aten::copy_", "copies"),
    ("Memcpy HtoD (Pageable -> Device)", None, "copies"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>",
     "aten::native_group_norm", "elementwise/norm"),
    ("some_custom_kernel", None, "other"),
])
def test_profile_buckets_by_kernel_name_and_op(name, op, bucket):
    assert _script("profile_torch_sd_denoise").classify(name, op) == bucket


def test_profile_reanalyzes_a_saved_trace(tmp_path, capsys):
    """--reanalyze on a Chrome trace and run.json of the layout ``trace``
    writes: kernels linked to their ops by "External id", busy time the
    union of the intervals, idle share against the traced wall."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "ts": 0, "dur": 5,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 10, "dur": 100,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "implicit_gemm_fprop", "ts": 50, "dur": 100,
         "args": {"External id": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 400, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 0,
         "dur": 1000},
    ]
    _write(str(tmp_path / "sd_denoise.json"), {"traceEvents": events})
    _write(str(tmp_path / "run.json"), {"steps": 2, "batch": 2, "step_ms_timed": 100.0,
                                        "traced_wall_ms": 1.0, "device_kind": "card",
                                        "peak_bf16_flops": 989.4e12})
    assert _script("profile_torch_sd_denoise").main(["--reanalyze", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["buckets_ms_per_step"]["attention-bmm"] == pytest.approx(0.05)
    assert rec["buckets_ms_per_step"]["conv"] == pytest.approx(0.05)
    assert rec["buckets_ms_per_step"]["copies"] == pytest.approx(0.025)
    # the union: 10..150 and 400..450 µs over 2 steps
    assert rec["device_busy_ms_per_step"] == pytest.approx(0.095)
    assert rec["device_idle_share"] == pytest.approx(0.81)
    assert rec["launches_per_step"] == 1.5
    assert rec["mfu_analytic"] == pytest.approx(3062.74e9 / 0.1 / 989.4e12, rel=1e-5)


def test_device_time_is_the_union_of_the_intervals():
    got = profiling.device_time([("a", 0, 10, None), ("b", 5, 15, "aten::mm"),
                                 ("a", 20, 30, None), ("c", 21, 22, None)])
    assert got["busy_ms"] == pytest.approx(0.025) and got["launches"] == 4
    assert got["kernels"][0] == ["a", 0.02, 2]
