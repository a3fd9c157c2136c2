"""Losses and image metrics (reference utils/loss_utils.py)."""

from __future__ import annotations

import torch

from ..ops.ssim import ssim as _ssim


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE, [B, ...] → [B, 1]."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR = 20·log10(1/√mse), [B, 1]."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def ssim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM, NCHW."""
    return _ssim(pred, gt)
