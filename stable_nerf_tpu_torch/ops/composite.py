"""Alpha compositing over masked [N, K] sample slabs with the closed-form
backward of the reference's CUDA kernels (raymarching.cu:501-726);
counterpart of stable_nerf_tpu/ops/composite.py.

Two deliberate choices of the reference are kept: no gradient flows
through depth, and samples after the early-exit point (transmittance
below ``t_thresh``) get zero gradient.
"""

from __future__ import annotations

import torch


def _composite_impl(t_thresh: float, sigmas, rgbs, dt, ts, t0, validf):
    sigmas = sigmas.float()
    rgbs = rgbs.float()
    alpha = validf * (1.0 - torch.exp(-sigmas * dt))             # [N, K]
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    T_before = torch.cat([torch.ones_like(T_after[:, :1]), T_after[:, :-1]], -1)
    # the CUDA loop breaks AFTER the sample that drops T below t_thresh, so
    # sample k counts iff every earlier sample left T_after >= t_thresh
    ok = (T_after >= t_thresh).float()
    include = torch.cat([torch.ones_like(ok[:, :1]),
                         torch.cumprod(ok[:, :-1], dim=-1)], dim=-1)
    weight = alpha * T_before * include
    weights_sum = weight.sum(-1)
    image = torch.einsum("nk,nkc->nc", weight, rgbs)
    # the CUDA per-step deltas telescope to (t_k + dt - t0)
    depth = (weight * (ts + dt - t0[:, None])).sum(-1)
    return weights_sum, depth, image, weight, T_after, include


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, rgbs, dt, ts, t0, validf, t_thresh):
        ws, depth, image, weight, T_after, include = _composite_impl(
            t_thresh, sigmas, rgbs, dt, ts, t0, validf)
        ctx.save_for_backward(rgbs, dt, validf, weight, T_after, include, ws,
                              image)
        ctx.dtypes = (sigmas.dtype, rgbs.dtype)
        return ws, depth, image

    @staticmethod
    def backward(ctx, g_ws, _g_depth, g_image):   # depth gradient dropped
        rgbs, dt, validf, weight, T_after, include, ws, image = ctx.saved_tensors
        sig_dtype, rgb_dtype = ctx.dtypes
        g_ws = g_ws.float()
        g_image = g_image.float()
        rgbs32 = rgbs.float()
        # dL/drgb_k = g_image · w_k                    (raymarching.cu:680-682)
        grad_rgbs = (g_image[:, None, :] * weight[..., None]).to(rgb_dtype)
        # dL/dsigma_k = dt·[Σ_c g_c (T_after_k·rgb_kc − Σ_{j>k} w_j rgb_jc)
        #                   + g_ws (1 − ws)]             (raymarching.cu:687-693)
        acc = torch.cumsum(weight[..., None] * rgbs32, dim=1)
        tail = image[:, None, :] - acc
        per_c = g_image[:, None, :] * (T_after[..., None] * rgbs32 - tail)
        gsig = per_c.sum(-1) + g_ws[:, None] * (1.0 - ws[:, None])
        grad_sigmas = (dt * validf * include * gsig).to(sig_dtype)
        return grad_sigmas, grad_rgbs, None, None, None, None, None


def composite_rays(sigmas, rgbs, dt, ts, t0, valid, t_thresh: float = 1e-4):
    """Composite [N, K] masked samples into per-ray values.

    Args:
      sigmas: [N, K] densities;  rgbs: [N, K, C] colors or latents.
      dt: step size (0-d tensor or float);  ts: [N, K];  t0: [N].
      valid: [N, K] bool sample mask from the march.

    Returns (weights_sum [N], depth [N], image [N, C]), all float32.
    """
    dt = torch.as_tensor(dt, dtype=torch.float32, device=sigmas.device)
    return _Composite.apply(sigmas, rgbs, dt, ts, t0, valid.float(),
                            float(t_thresh))
