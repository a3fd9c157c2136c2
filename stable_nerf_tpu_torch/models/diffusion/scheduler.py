"""DDIM noise scheduler with diffusers' numerics and the SDXL settings
(counterpart of stable_nerf_tpu/models/diffusion/scheduler.py).

The tables are computed in float64 with numpy and stored as float32
tensors on the chosen device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import SchedulerConfig
from ...utils.device import resolve_device


class DDIMScheduler(NamedTuple):
    config: SchedulerConfig
    alphas_cumprod: torch.Tensor        # [T] float32
    final_alpha_cumprod: torch.Tensor   # 0-d float32

    @classmethod
    def create(cls, config: Optional[SchedulerConfig] = None, *,
               device: Optional[torch.device] = None) -> "DDIMScheduler":
        config = config or SchedulerConfig()
        dev = resolve_device(device)
        T = config.num_train_timesteps
        if config.beta_schedule == "scaled_linear":
            betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, T) ** 2
        elif config.beta_schedule == "linear":
            betas = np.linspace(config.beta_start, config.beta_end, T)
        else:
            raise ValueError(f"unsupported beta_schedule {config.beta_schedule}")
        acp = np.cumprod(1.0 - betas)
        final = 1.0 if config.set_alpha_to_one else acp[0]
        return cls(
            config=config,
            alphas_cumprod=torch.tensor(acp.astype(np.float32), device=dev),
            final_alpha_cumprod=torch.tensor(np.float32(final), device=dev),
        )

    def _at(self, timesteps, ndim: int) -> torch.Tensor:
        acp = self.alphas_cumprod[torch.as_tensor(timesteps,
                                                  device=self.alphas_cumprod.device)]
        return acp.reshape((-1,) + (1,) * (ndim - 1))

    def add_noise(self, samples, noise, timesteps):
        """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε."""
        acp = self._at(timesteps, samples.dim())
        return torch.sqrt(acp) * samples + torch.sqrt(1.0 - acp) * noise

    def get_velocity(self, samples, noise, timesteps):
        """v = √ᾱ·ε − √(1−ᾱ)·x₀."""
        acp = self._at(timesteps, samples.dim())
        return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * samples

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending timesteps, 'leading' spacing + offset (set_timesteps)."""
        c = self.config
        if c.timestep_spacing == "leading":
            ratio = c.num_train_timesteps // num_inference_steps
            ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
            return ts.astype(np.int64) + c.steps_offset
        if c.timestep_spacing == "trailing":
            ratio = c.num_train_timesteps / num_inference_steps
            return (np.arange(c.num_train_timesteps, 0, -ratio).round() - 1).astype(np.int64)
        raise ValueError(f"unsupported timestep_spacing {c.timestep_spacing}")

    def _lookup(self, t: torch.Tensor) -> torch.Tensor:
        """``alphas_cumprod`` at the integer tensor ``t``, in ``t``'s shape,
        without a host read."""
        return self.alphas_cumprod.index_select(0, t.reshape(-1)).reshape(t.shape)

    def step(self, model_output, timestep, sample, *, num_inference_steps: int,
             eta: float = 0.0, noise=None):
        """One DDIM update x_t → x_{t−Δ}; returns (prev_sample, pred_x0)."""
        c = self.config
        dev = self.alphas_cumprod.device
        t = torch.as_tensor(timestep, device=dev)
        prev_t = t - c.num_train_timesteps // num_inference_steps
        # a gather, not ``table[t]``: indexing by a 0-d tensor reads the
        # index to the host, which would synchronize (and break a capture)
        alpha_prod_t = self._lookup(t)
        alpha_prod_prev = torch.where(
            prev_t >= 0, self._lookup(torch.clamp(prev_t, min=0)),
            self.final_alpha_cumprod)
        beta_prod_t = 1.0 - alpha_prod_t
        if c.prediction_type == "epsilon":
            pred_x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(alpha_prod_t)
            pred_eps = model_output
        elif c.prediction_type == "v_prediction":
            pred_x0 = torch.sqrt(alpha_prod_t) * sample - torch.sqrt(beta_prod_t) * model_output
            pred_eps = torch.sqrt(alpha_prod_t) * model_output + torch.sqrt(beta_prod_t) * sample
        else:
            raise ValueError(f"unsupported prediction_type {c.prediction_type}")
        if c.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        variance = (1.0 - alpha_prod_prev) / (1.0 - alpha_prod_t) * (
            1.0 - alpha_prod_t / alpha_prod_prev)
        std = eta * torch.sqrt(variance)
        dir_xt = torch.sqrt(1.0 - alpha_prod_prev - std ** 2) * pred_eps
        prev_sample = torch.sqrt(alpha_prod_prev) * pred_x0 + dir_xt
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            prev_sample = prev_sample + std * noise
        return prev_sample, pred_x0
