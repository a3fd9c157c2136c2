"""Density activations (counterpart of stable_nerf_tpu/ops/activation.py)."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    """exp(x) whose gradient is g·exp(clamp(x, −15, 15)): it never
    explodes and, unlike ReLU, never dies (reference nerf/activation.py)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
