"""scripts/torch_study.py and the port's study scripts on the CPU: what can
be held without a card.

* The occupancy-driven eval budget equals the JAX package's, also at the
  committed synthetic scene's analytic occupancy.
* ``best_ms`` and ``device_line`` on the CPU: a positive finite time on the
  host clock, and the note that says so.
* The sweeps refuse to write the TPU's records; the full-SDXL bench's
  ``--remat`` builds the remat U-Net and counts its FLOPs × 4/3, as
  bench_joint_full_sdxl.py does; the denoise profile's buckets and its
  ``--reanalyze`` of a saved trace; the profiling helpers' busy time.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

import bench as jbench
from stable_nerf_tpu.config import NeRFConfig as JNeRFConfig
from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.training.joint import eval_budget_for_occupancy as jax_budget
from stable_nerf_tpu_torch.config import TrainConfig
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


study = _script("torch_study")


@pytest.mark.parametrize("occ", ["scene", 0.0, 0.003, 0.05, 0.5, 1.0, None])
def test_auto_eval_budget_equals_jax(occ):
    if occ == "scene":
        occ = float(jbench._scene_occupancy_grid(JNeRFConfig(channel_dim=4)).mean())
    assert eval_budget_for_occupancy(occ, 4096, TrainConfig()) == jax_budget(
        occ, 4096, JTrainConfig())


def test_best_ms_and_device_line_on_the_cpu():
    calls = []
    ms = study.best_ms(lambda: calls.append(sum(range(1000))), "cpu", n_iters=4, n_blocks=2)
    assert math.isfinite(ms) and ms > 0 and len(calls) == 1 + 2 * 4
    assert study.device_line("cpu") == "cpu (host clock: PyTorch's CPU kernels, no device time)"


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


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
        assert getattr(study, "BATCH_SWEEP" if "batch" in script else "HYBRID_SWEEP") == name


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
