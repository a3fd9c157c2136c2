"""The port (stable_nerf_tpu_torch) stands alone: no JAX, nothing of the JAX
package, entry points that refuse to fall back to the CPU, and a chip
smoke script that fails without a card or without the package."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import stable_nerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.load_floor_script()      # scripts/bench_torch_fused_render_floor.py
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "stable_nerf_tpu"))
print(len(names), bad)
print(" ".join(names))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_neither_jax_nor_reference_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    first, names = out.stdout.strip().split("\n")
    n, bad = first.split(" ", 1)
    assert int(n) >= 42
    assert bad.strip() == "[]", bad
    for mod in ("ops.compaction", "ops.ssim", "ops.hopper.gather",
                "training.inference", "utils.losses", "ops.morton",
                "data.preprocess", "data.dataset", "data.prefetch",
                "utils.profiling", "utils.visualization",
                "training.checkpoints", "training.loop", "train"):
        assert f"stable_nerf_tpu_torch.{mod}" in names.split(), mod


def _entry_points():
    from stable_nerf_tpu_torch.config import NeRFConfig
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import sd_network_init
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch import train as cli
    from stable_nerf_tpu_torch.data.prefetch import device_prefetch
    from stable_nerf_tpu_torch.models.nerf.grid import reset_extra_state
    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.training.joint import (JointConfig, make_eval_step,
                                                      make_train_step)
    from stable_nerf_tpu_torch.training.loop import build_initial_params, train

    return {
        "nerf_init": lambda: nerf_init(0, NeRFConfig()),
        "sd_network_init": lambda: sd_network_init(0),
        "grid_init": lambda: grid_init(NeRFConfig()),
        "scheduler": lambda: DDIMScheduler.create(),
        "make_train_step": lambda: make_train_step(JointConfig(), None, None),
        "make_eval_step": lambda: make_eval_step(JointConfig(), None),
        "make_inference_step": lambda: make_inference_step(JointConfig(), None),
        "reset_extra_state": lambda: reset_extra_state(NeRFConfig()),
        "train": lambda: train(JointConfig(), None),
        "build_initial_params": lambda: build_initial_params(JointConfig(), 0, 1),
        "device_prefetch": lambda: next(device_prefetch(iter([{}]))),
        "cli": lambda: cli.main(["--tiny", "--dataset", "synthetic"]),
    }


@pytest.mark.parametrize("name", ["nerf_init", "sd_network_init", "grid_init",
                                  "scheduler", "make_train_step", "make_eval_step",
                                  "make_inference_step", "reset_extra_state", "train",
                                  "build_initial_params", "device_prefetch", "cli"])
def test_entry_points_default_to_cuda_and_refuse_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    # in the repo: no card here, so it must exit non-zero with no result
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                             env=_clean_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and '"ok": true' not in out.stdout
    # alone in a directory: the package is missing, whatever the device
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
