"""SSIM metric by separable Gaussian depthwise convolution (counterpart of
stable_nerf_tpu/ops/ssim.py): an 11-tap Gaussian window (sigma 1.5),
C1 = 0.01², C2 = 0.03², mean over the interior.  The convolutions run in
full float32 (TF32 would not survive the ``blur(x²) − mu²`` cancellation
of the variance estimate), so callers on a card keep
``torch.backends.cudnn.allow_tf32`` off (utils/device.py::disable_tf32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian blur, NCHW, zero 'same' padding."""
    n, c, h, w = img.shape
    k = kernel.shape[0]
    x = img.reshape(n * c, 1, h, w)
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1), padding=((k - 1) // 2, 0))
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k), padding=(0, (k - 1) // 2))
    return x.reshape(n, c, h, w)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a batch; images [N, C, H, W] in [0, 1]."""
    img1, img2 = img1.float(), img2.float()
    kernel = _gaussian_kernel(window_size, sigma, img1.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(img1, kernel), _blur(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # true variances are non-negative: a tiny negative value is cancellation
    # noise (the covariance may be negative)
    sigma1_sq = torch.clamp(_blur(img1 * img1, kernel) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_blur(img2 * img2, kernel) - mu2_sq, min=0.0)
    sigma12 = _blur(img1 * img2, kernel) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    # mean over the valid interior: the zero-padded border biases the
    # window moments
    b = (window_size - 1) // 2
    if ssim_map.shape[-1] > 2 * b and ssim_map.shape[-2] > 2 * b:
        ssim_map = ssim_map[..., b:-b, b:-b]
    return ssim_map.mean()
