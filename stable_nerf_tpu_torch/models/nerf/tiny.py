"""tiny-NeRF: frequency encoding, an 8-layer MLP and plain stratified
sampling (counterpart of stable_nerf_tpu/models/nerf/tiny.py).

The classic NeRF on tiny_nerf_data.npz-style scenes: no occupancy grid,
no hash tables, dense sampling only (the reference's test_nerf.py:146-200
workload).  Params are a NamedTuple of tensors with the JAX package's
layouts (dense kernels [in, out], applied as ``h @ w + b``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...config import TinyNeRFConfig
from ...ops.activation import trunc_exp
from ...ops.encoding import freq_encoding
from ...utils.device import resolve_device


class TinyNeRFParams(NamedTuple):
    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    # rgb head (conditioned on view directions when cfg.use_viewdirs)
    rgb_w: Tuple[torch.Tensor, ...]
    rgb_b: Tuple[torch.Tensor, ...]
    sigma_w: torch.Tensor
    sigma_b: torch.Tensor


_SKIP_LAYER = 4  # classic NeRF: the encoded input joins again at layer 4


def tiny_nerf_init(seed: int, cfg: TinyNeRFConfig, *,
                   device: Optional[torch.device] = None) -> TinyNeRFParams:
    """Random params from ``seed`` on ``device`` (default cuda): U(±1/√in)
    kernels, zero biases."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    pos_dim = 3 * (2 * cfg.n_freqs_pos + 1)
    dir_dim = 3 * (2 * cfg.n_freqs_dir + 1)
    W = cfg.width

    def dense(din, dout):
        scale = (1.0 / din) ** 0.5
        w = torch.empty((din, dout), device=dev).uniform_(-scale, scale, generator=g)
        return w, torch.zeros(dout, device=dev)

    ws, bs, din = [], [], pos_dim
    for i in range(cfg.n_layers):
        if i == _SKIP_LAYER:
            din += pos_dim
        w, b = dense(din, W)
        ws.append(w)
        bs.append(b)
        din = W
    sigma_w, sigma_b = dense(W, 1)
    if cfg.use_viewdirs:
        heads = [dense(W, W), dense(W + dir_dim, W // 2), dense(W // 2, 3)]  # feature, hidden, out
    else:
        heads = [dense(W, 3)]
    return TinyNeRFParams(tuple(ws), tuple(bs), tuple(w for w, _ in heads),
                          tuple(b for _, b in heads), sigma_w, sigma_b)


def tiny_nerf_apply(params: TinyNeRFParams, x: torch.Tensor, d: torch.Tensor,
                    cfg: TinyNeRFConfig):
    """x [..., 3] positions, d [..., 3] unit view directions → (sigma [...]
    before its activation, rgb [..., 3])."""
    xe = freq_encoding(x, cfg.n_freqs_pos, include_input=True)
    h = xe
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        if i == _SKIP_LAYER:
            h = torch.cat([h, xe], dim=-1)
        h = torch.relu(h @ w + b)
    sigma = (h @ params.sigma_w + params.sigma_b)[..., 0]
    if cfg.use_viewdirs:
        de = freq_encoding(d, cfg.n_freqs_dir, include_input=True)
        (fw, hw, ow), (fb, hb, ob) = params.rgb_w, params.rgb_b
        h2 = torch.relu(torch.cat([h @ fw + fb, de], dim=-1) @ hw + hb)
        rgb = torch.sigmoid(h2 @ ow + ob)
    else:
        rgb = torch.sigmoid(h @ params.rgb_w[0] + params.rgb_b[0])
    return sigma, rgb


def render_tiny(params: TinyNeRFParams, rays_o: torch.Tensor, rays_d: torch.Tensor,
                cfg: TinyNeRFConfig, *, u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                white_bg: bool = False) -> Dict[str, torch.Tensor]:
    """Stratified-sampling volume render of rays [..., 3].

    u: [N, n_samples] uniforms placing each sample in its bin (training
      jitter); drawn from ``generator`` where it is given instead; the bin
      centres (0.5) when neither is.

    Returns {'image': [..., 3], 'depth': [...], 'weights_sum': [...]}.
    """
    prefix = rays_o.shape[:-1]
    o, d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    N, S, dev = o.shape[0], cfg.n_samples, o.device
    edges = torch.linspace(cfg.near, cfg.far, S + 1, device=dev)
    lower, upper = edges[:-1], edges[1:]
    if u is None:
        u = (torch.rand((N, S), generator=generator, device=dev) if generator is not None
             else torch.full((N, S), 0.5, device=dev))
    ts = lower[None, :] + (upper - lower)[None, :] * u                     # [N, S]
    pos = o[:, None, :] + ts[..., None] * d[:, None, :]
    sigma, rgb = tiny_nerf_apply(params, pos, d[:, None, :].expand(pos.shape), cfg)

    # the last delta is the mean bin width, not the classic 1e10: with a
    # strictly positive density that would pin the last alpha to 1 and
    # swallow the background
    deltas = torch.cat([torch.diff(ts, dim=-1),
                        torch.full((N, 1), (cfg.far - cfg.near) / S, device=dev)], dim=-1)
    alpha = 1.0 - torch.exp(-trunc_exp(sigma - 1.0) * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones((N, 1), device=dev), trans[:, :-1]], dim=-1)
    weights = alpha * trans                                                 # [N, S]
    image = torch.einsum("ns,nsc->nc", weights, rgb)
    depth = (weights * ts).sum(dim=-1)
    ws = weights.sum(dim=-1)
    if white_bg:
        image = image + (1.0 - ws)[:, None]
    return {"image": image.reshape(*prefix, 3), "depth": depth.reshape(*prefix),
            "weights_sum": ws.reshape(*prefix)}
