"""The instant-ngp style NeRF: hash encoding + bias-free sigma/color MLPs
(counterpart of stable_nerf_tpu/models/nerf/network.py).

Params are a plain dict {"hash": {"table"}, "sigma_mlp": {"layers"},
"color_mlp": {"layers"}} with MLP weights stored [in, out].
``compute_dtype=torch.bfloat16`` runs the matmul chain (relus included)
in bf16 and keeps sigma in f32, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...config import NeRFConfig
from ...ops.activation import trunc_exp
from ...ops.encoding import hash_grid_encode, hash_grid_init, sh_encoding
from ...utils.device import resolve_device


def _mlp_init(generator, in_dim: int, out_dim: int, width: int, n_hidden: int,
              device) -> Dict:
    """He-uniform [in → width ×n_hidden → out], no biases."""
    dims = [in_dim] + [width] * n_hidden + [out_dim]
    layers = []
    for di, do in zip(dims[:-1], dims[1:]):
        bound = (6.0 / di) ** 0.5
        w = torch.empty((di, do), dtype=torch.float32, device=device)
        layers.append(w.uniform_(-bound, bound, generator=generator))
    return {"layers": layers}


def _mlp_apply(params: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = x.to(compute_dtype)
    layers = params["layers"]
    for i, w in enumerate(layers):
        h = h @ w.to(compute_dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def nerf_init(seed: int, cfg: NeRFConfig, *,
              device: Optional[torch.device] = None) -> Dict:
    """Random NeRF params from ``seed`` on ``device`` (default cuda)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "hash": hash_grid_init(g, cfg.encoding_sigma, dev),
        "sigma_mlp": _mlp_init(g, cfg.encoding_sigma.output_dim,
                               1 + cfg.geo_feat_dim, cfg.network_sigma.n_neurons,
                               cfg.network_sigma.n_hidden_layers, dev),
        "color_mlp": _mlp_init(g, cfg.encoding_dir.output_dim + cfg.geo_feat_dim,
                               cfg.channel_dim, cfg.network_color.n_neurons,
                               cfg.network_color.n_hidden_layers, dev),
    }


def nerf_density(params: Dict, x, cfg: NeRFConfig, compute_dtype=torch.float32,
                 stochastic: bool = False) -> Dict[str, torch.Tensor]:
    """x [..., 3] in [-bound, bound] → {'sigma' [...] f32, 'geo_feat'}."""
    xn = (x + cfg.bound) / (2 * cfg.bound)
    h = hash_grid_encode(params["hash"], xn, cfg.encoding_sigma,
                         custom_bwd=cfg.hash_custom_bwd, stochastic=stochastic,
                         grad_bf16=cfg.hash_grad_bf16,
                         stochastic_min_level=cfg.hash_stochastic_min_level)
    h = _mlp_apply(params["sigma_mlp"], h, compute_dtype)
    h0 = h[..., 0].float()
    sigma = trunc_exp(h0) if cfg.density_activation == "trunc_exp" else torch.relu(h0)
    return {"sigma": sigma, "geo_feat": h[..., 1:]}


def nerf_color(params: Dict, d, geo_feat, cfg: NeRFConfig,
               compute_dtype=torch.float32) -> torch.Tensor:
    """Color from unit directions [..., 3] and geo features, f32 output."""
    sh = sh_encoding((d + 1.0) / 2.0, cfg.encoding_dir.degree)
    h = torch.cat([sh.to(compute_dtype), geo_feat.to(compute_dtype)], dim=-1)
    h = _mlp_apply(params["color_mlp"], h, compute_dtype)
    return torch.sigmoid(h).float()


def nerf_apply(params: Dict, x, d, cfg: NeRFConfig, compute_dtype=torch.float32,
               stochastic: bool = False):
    """Full forward → (sigma [...] f32, color [..., channel_dim] f32)."""
    dens = nerf_density(params, x, cfg, compute_dtype, stochastic=stochastic)
    return dens["sigma"], nerf_color(params, d, dens["geo_feat"], cfg,
                                     compute_dtype)
