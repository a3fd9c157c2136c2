"""The port (stable_nerf_tpu_torch) stands alone: no JAX, nothing of the JAX
package, none of ``safetensors``, ``transformers`` or PIL (the card's
machine has none of them) and no pre-port script, in the package,
chip_smoke.py and the port's scripts; entry points that refuse to fall
back to the CPU, and a chip smoke script that fails without a card or
without the package."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, os, pkgutil, sys
import stable_nerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.load_floor_script()      # scripts/bench_torch_fused_render_floor.py
for script in ("torch_study", "fit_torch_nerf", "pretrain_torch_tiny_vae",
               "fit_torch_latent_ceiling", "bench_torch_joint_full_sdxl",
               "profile_torch_sd_denoise", "run_torch_sd",
               "validate_torch_sdxl_checkpoint", "bench_torch_batch_sweep",
               "bench_torch_hybrid_sweep", "bench_torch_scatter_variants",
               "bench_torch_step_ablation", "bench_torch_eval_ablation",
               "bench_torch_encode_split", "bench_torch_table_dtype",
               "bench_torch_gather_by_table", "bench_torch_unet_layout",
               "bench_torch_grid_refresh", "make_torch_sdxl_key_manifest",
               "make_torch_synthetic_scene", "weights_torch_drill_full_size"):
    chip_smoke.load_script(script)
# the JAX package's root scripts and pre-port scripts/ files
pre_port = {"bench", "train", "__graft_entry__"} | {
    f[:-3] for f in os.listdir("scripts") if f.endswith(".py") and "torch" not in f}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "stable_nerf_tpu", "safetensors",
                                    "transformers", "PIL") or m in pre_port)
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
    assert int(n) >= 50
    assert bad.strip() == "[]", bad
    for mod in ("ops.compaction", "ops.ssim", "ops.hopper.gather",
                "training.inference", "utils.losses", "ops.morton",
                "data.preprocess", "data.dataset", "data.prefetch",
                "utils.profiling", "utils.visualization",
                "training.checkpoints", "training.loop", "train", "utils.safetensors",
                "models.diffusion.weights", "models.diffusion.clip_text",
                "models.diffusion.clip_vision", "models.diffusion.tokenizer",
                "data.native_loader", "models.nerf.error_map", "models.nerf.tiny",
                "parallel", "parallel.sharding", "parallel.fsdp", "parallel.tp",
                "parallel.sp"):
        assert f"stable_nerf_tpu_torch.{mod}" in names.split(), mod


STUDY_SCRIPTS = ("bench_torch_scatter_variants", "bench_torch_step_ablation",
                 "bench_torch_eval_ablation", "bench_torch_encode_split",
                 "bench_torch_table_dtype", "bench_torch_gather_by_table",
                 "bench_torch_unet_layout", "bench_torch_grid_refresh")


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
    from stable_nerf_tpu_torch.models.diffusion.clip_text import (clip_l_config,
                                                                  clip_text_init)
    from stable_nerf_tpu_torch.models.diffusion.clip_vision import (CLIPVisionConfig,
                                                                    clip_vision_init)
    from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl
    from stable_nerf_tpu_torch.models.diffusion.vae import vae_load_npz
    from stable_nerf_tpu_torch.models.nerf.error_map import error_map_init
    from stable_nerf_tpu_torch.config import TinyNeRFConfig
    from stable_nerf_tpu_torch.models.nerf.tiny import tiny_nerf_init
    from stable_nerf_tpu_torch.parallel import make_mesh, make_mesh_2d
    from stable_nerf_tpu_torch.training.inference import make_sharded_inference_step
    import chip_smoke

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
        "load_sdxl": lambda: load_sdxl("no-such-directory"),
        "clip_text_init": lambda: clip_text_init(0, clip_l_config()),
        "clip_vision_init": lambda: clip_vision_init(0, CLIPVisionConfig()),
        "vae_load_npz": lambda: vae_load_npz(os.path.join(REPO, "runs", "demo_vae",
                                                          "vae.npz")),
        "error_map_init": lambda: error_map_init(4),
        "tiny_nerf_init": lambda: tiny_nerf_init(0, TinyNeRFConfig()),
        "bench_joint_full_sdxl_script": lambda: chip_smoke.load_script(
            "bench_torch_joint_full_sdxl").main([]),
        "profile_sd_denoise_script": lambda: chip_smoke.load_script(
            "profile_torch_sd_denoise").main(["--outdir", os.path.join(REPO, "no-such-dir")]),
        "run_sd_script": lambda: chip_smoke.load_script("run_torch_sd").main(["--tiny"]),
        "validate_script": lambda: chip_smoke.load_script(
            "validate_torch_sdxl_checkpoint").main(["--checkpoint", "no-such-directory"]),
        "make_mesh": lambda: make_mesh(),
        "train_data_parallel": lambda: train(JointConfig(), None, data_parallel=True),
        "cli_data_parallel": lambda: cli.main(["--tiny", "--dataset", "synthetic",
                                               "--data-parallel", "--fsdp"]),
        "cli_coordinator": lambda: cli.main(["--tiny", "--coordinator", "localhost:1",
                                             "--num-processes", "2", "--process-id", "0",
                                             "--workdir", os.path.join(REPO, "no-such-dir")]),
        "make_mesh_2d": lambda: make_mesh_2d(),
        "make_sharded_inference_step": lambda: make_sharded_inference_step(
            JointConfig(), None, mesh=make_mesh_2d()),
        "cli_tensor_parallel": lambda: cli.main(["--tiny", "--dataset", "synthetic",
                                                 "--tensor-parallel", "2"]),
        "run_sd_sharded_script": lambda: chip_smoke.load_script("run_torch_sd").main(
            ["--tiny", "--tp", "2"]),
        **{f"{name}_script": (lambda name=name: chip_smoke.load_script(name).main([]))
           for name in STUDY_SCRIPTS},
    }


@pytest.mark.parametrize("name", ["nerf_init", "sd_network_init", "grid_init",
                                  "scheduler", "make_train_step", "make_eval_step",
                                  "make_inference_step", "reset_extra_state", "train",
                                  "build_initial_params", "device_prefetch", "cli",
                                  "load_sdxl", "clip_text_init", "clip_vision_init",
                                  "vae_load_npz", "error_map_init", "tiny_nerf_init",
                                  "bench_joint_full_sdxl_script", "profile_sd_denoise_script",
                                  "run_sd_script", "validate_script", "make_mesh",
                                  "train_data_parallel", "cli_data_parallel",
                                  "cli_coordinator", "make_mesh_2d",
                                  "make_sharded_inference_step", "cli_tensor_parallel",
                                  "run_sd_sharded_script",
                                  *(f"{name}_script" for name in STUDY_SCRIPTS)])
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
