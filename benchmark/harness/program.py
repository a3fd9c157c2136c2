"""The configuration files as the program's own configuration classes.

Imports ``stable_nerf_tpu_torch`` (the system under test) inside the
functions only: a module of the benchmark imports no program code when it
is imported.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def nerf_config(n: Dict, **overrides):
    from stable_nerf_tpu_torch.config import HashGridConfig, MLPConfig, NeRFConfig, SHConfig

    nested = {"encoding_sigma": HashGridConfig(**n["encoding_sigma"]),
              "network_sigma": MLPConfig(**n["network_sigma"]),
              "encoding_dir": SHConfig(**n["encoding_dir"]),
              "network_color": MLPConfig(**n["network_color"])}
    flat = {k: v for k, v in n.items() if k not in nested}
    return NeRFConfig(**{**flat, **nested, **overrides})


def joint_config(cfg: Dict, **nerf_overrides):
    from stable_nerf_tpu_torch.config import SchedulerConfig, SDConfig, TrainConfig
    from stable_nerf_tpu_torch.models.diffusion.sd_network import SDNetworkConfig
    from stable_nerf_tpu_torch.models.diffusion.unet import UNetConfig
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig
    from stable_nerf_tpu_torch.training.joint import JointConfig

    sd = SDNetworkConfig(sd=SDConfig(**cfg["sd"]), unet=UNetConfig(**_tuples(cfg["unet"])),
                         vae=VAEConfig(**_tuples(cfg["vae"])),
                         scheduler=SchedulerConfig(**cfg["scheduler"]))
    return JointConfig(nerf=nerf_config(cfg["nerf"], **nerf_overrides), sd=sd,
                       train=TrainConfig(**cfg["train"]))


def fit_module():
    """``scripts/fit_torch_nerf.py``, the NeRF fit harness, as a module."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import fit_torch_nerf

    return fit_torch_nerf
