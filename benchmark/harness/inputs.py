"""What the benchmark makes from the seed and hands to both sides: the
weights, the random draws of each step or request, and the order of the
scenes.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference import nerf as ref_nerf
from ..reference import sd as ref_sd
from . import weights

# generator streams of one seed (the weights' dtype groups take 0 and 1)
S_CHECKED = 10         # 10..12: the draws of the three checked steps
S_GRID = 20            # the set-up refresh's jitter
S_WINDOW = 30          # the window's own draws
S_REQUEST = 1000       # 1000 + r: request r's draws
IP_HEADS = ("to_k_ip", "to_v_ip")


def trainable(path: tuple) -> bool:
    """Trainable scope "reference" (train.py:179-182): the NeRF, the image
    projection, the downsampling CNN and every IP head."""
    return (path[0] == "nerf" or path[1] in ("image_proj", "downsampling")
            or any(k in IP_HEADS for k in path))


def _nerf_template(n: Dict, table_scale):
    t = ref_nerf.nerf_template(n)
    if table_scale is not None:
        t["hash"]["table"] = t["hash"]["table"]._replace(scale=float(table_scale))
    return t


def joint_weights(cfg: Dict, seed: int, device, table_scale=None) -> Dict:
    """{"sd", "nerf"} at the configuration's widths: frozen leaves in the
    served dtype, trainable ones float32; each IP head starts as a copy of
    its cross-attention's to_k / to_v (network.py:104-110).  The hash table
    is uniform in ±``table_scale`` where given (a fitted field), else at
    tcnn's init."""
    frozen = getattr(torch, cfg["precision"]["frozen"])
    template = {"sd": ref_sd.sd_template(cfg), "nerf": _nerf_template(cfg["nerf"], table_scale)}
    params = weights.make(template, seed, device,
                          lambda p: torch.float32 if trainable(p) else frozen)
    with torch.no_grad():
        for path, leaf in weights.leaves_with_path(params):
            if path[-2] in IP_HEADS:
                src = weights.get(params, path[:-2] + (path[-2][:4],) + path[-1:])
                leaf.copy_(src)
    u = cfg["unet"]
    params["sd"]["add_text_embeds"] = torch.zeros((1, u["pooled_projection_dim"]),
                                                  dtype=frozen, device=device)
    params["sd"]["add_time_ids"] = torch.tensor(
        [[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]], dtype=frozen, device=device)
    return params


def nerf_weights(cfg: Dict, seed: int, device) -> Dict:
    return weights.make(ref_nerf.nerf_template(cfg["nerf"]), seed, device,
                        lambda p: torch.float32)


def joint_draws(cfg: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One train step's draws at batch B: VAE eps, noise, timesteps, the
    rays' t0 jitter."""
    B, h = cfg["train"]["batch_size"], cfg["sd"]["latent_size"]
    c = cfg["sd"]["latent_channels"]
    return {"vae_eps": torch.randn((2 * B, c, h, h), generator=g, device=device),
            "noise": torch.randn((B, c, h, h), generator=g, device=device),
            "timesteps": torch.randint(0, cfg["scheduler"]["num_train_timesteps"], (B,),
                                       generator=g, device=device),
            "perturb": torch.rand(2 * B * h * h, generator=g, device=device)}


def request_draws(cfg: Dict, batch: int, seed: int, r: int, device) -> Dict[str, torch.Tensor]:
    """Request ``r``'s draws: the reference view's VAE eps and the initial
    latents."""
    g = weights.generator(seed, S_REQUEST + r, device)
    h, c = cfg["sd"]["latent_size"], cfg["sd"]["latent_channels"]
    return {"vae_eps": torch.randn((batch, c, h, h), generator=g, device=device),
            "init_latents": torch.randn((batch, c, h, h), generator=g, device=device)}


def grid_noise(cfg: Dict, seed: int, device) -> Dict[str, List[torch.Tensor]]:
    """The set-up refresh's jitter: a full sweep of every cascade."""
    n = cfg["nerf"]
    g = weights.generator(seed, S_GRID, device)
    return {"noise": [torch.rand((n["grid_size"] ** 3, 3), generator=g, device=device) * 2 - 1
                      for _ in range(ref_nerf.cascade(n))]}


def split(n: int, seed: int):
    """The loop's 80 / 10 / 10 split of ``n`` scenes (train.py:164-170)."""
    perm = np.random.default_rng(seed).permutation(n)
    a, b = int(0.8 * n), int(0.1 * n)
    return perm[:a], perm[a:a + b], perm[a + b:]


def epoch_order(indices, seed: int, epoch: int) -> np.ndarray:
    idx = np.array(indices)
    np.random.default_rng([seed, epoch]).shuffle(idx)
    return idx


def request_scenes(test, batch: int, seed: int, r: int) -> np.ndarray:
    """The ``batch`` distinct test scenes of request ``r``."""
    return np.random.default_rng([seed, S_REQUEST + r]).choice(test, size=batch, replace=False)
